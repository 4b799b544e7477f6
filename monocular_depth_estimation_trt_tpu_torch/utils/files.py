"""Data-file location helpers (counterpart of the JAX package's
``utils/files.py``, reference ``common.py`` parity).

The reference's ``common.py`` provides ``find_sample_data``/``locate_files``
(``common.py:42,97``) to resolve test assets across candidate directories.
"""

from __future__ import annotations

import os
from typing import List, Sequence

IMAGE_EXTENSIONS = frozenset({".png", ".jpg", ".jpeg", ".bmp"})


def list_images(directory: str) -> List[str]:
    """Sorted image paths in a directory (the reference's frame-dir listing
    idiom, ``RAFT/onnx2trt.py:150-155``)."""
    return sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS
    )


def locate_files(data_paths: Sequence[str], filenames: Sequence[str],
                 err_msg: str = "") -> List[str]:
    """Find each filename in the first data path that contains it (reference
    ``common.py:97-131``: every file must resolve)."""
    found = [None] * len(filenames)
    for data_path in data_paths:
        if all(found):
            break
        for i, fname in enumerate(filenames):
            if found[i]:
                continue
            p = os.path.abspath(os.path.join(data_path, fname))
            if os.path.exists(p):
                found[i] = p
    for fname, f in zip(filenames, found):
        if not f or not os.path.exists(f):
            raise FileNotFoundError(
                f"Could not find {fname}. Searched in: {list(data_paths)}. {err_msg}")
    return found  # type: ignore[return-value]


def find_sample_data(description: str = "Runs a sample", subfolder: str = "",
                     find_files: Sequence[str] = ()) -> tuple:
    """argparse helper of reference ``common.py:42-95``: resolves a data
    directory (default: the repository's ``data/``) and required files in it."""
    import argparse

    parser = argparse.ArgumentParser(description=description)
    default_data = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data")
    parser.add_argument("-d", "--datadir", default=default_data,
                        help="Location of the files to run on.")
    args, _ = parser.parse_known_args()
    data_root = os.path.join(args.datadir, subfolder) if subfolder else args.datadir
    files = locate_files([data_root, args.datadir], find_files) if find_files else []
    return data_root, files

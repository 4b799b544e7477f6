"""Expected-checkpoint-key manifests (counterpart of the JAX package's
``weights/manifest.py``).

A manifest pins, per model family, the upstream torch ``state_dict`` layout
at production scale: tensor names and shapes. The port's modules carry the
upstream names, so a manifest is also the port's own key set. The port keeps
its own copy of the files (``weights/manifests/*.json``, byte for byte the
JAX package's) and reads nothing of the JAX package.

Use: before trusting an upstream checkpoint, diff it against the manifest
with ``convert ... --verify-manifest``: a layout mismatch (renamed block,
extra head, other depth) is reported as missing, extra or shape-mismatched
keys before any load.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional

# Bookkeeping tensors no inference load is expected to consume (the JAX
# package's ``weights/convert.py`` ``_AUDIT_IGNORE``).
AUDIT_IGNORE = re.compile(r"(num_batches_tracked$|^n_averaged$)")


def manifest_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "manifests")


def manifest_path(key: str) -> str:
    return os.path.join(manifest_dir(), f"{key}.json")


# Registry model name -> manifest family. Families that share one layout
# share one manifest (the whole DA-V2 family: Distill-Any-Depth, DA-AC, DKT
# and BRIDGE load the same architecture).
_FAMILY_ALIASES = {
    "distill_any_depth": "depth_anything_v2",
    "depth_anything_ac": "depth_anything_v2",
    "dkt": "depth_anything_v2",
    "bridge": "depth_anything_v2",
    "unidepth_v2": "unidepth",
    "streamvggt": "vggt",
    "litevggt": "vggt",
    "metric_anything": "metric_anything",
}

# Families whose manifest does not depend on the encoder (one production
# configuration).
_NO_ENCODER = {
    "depth_pro", "vggt", "map_anything", "raft", "neuflow", "meflow",
    "memfof", "metric_anything", "cotracker3", "align3r", "stream3r",
}


def manifest_key(model: str, encoder: str = "") -> str:
    """Resolve (registry model, encoder) to a manifest file key."""
    fam = _FAMILY_ALIASES.get(model, model)
    if fam in _NO_ENCODER or not encoder:
        return fam
    return f"{fam}_{encoder}"


def load_manifest(key: str) -> Optional[Dict[str, Any]]:
    """The manifest of ``key``, or None where there is none."""
    path = manifest_path(key)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def verify_state_dict(sd: Mapping, manifest: Dict[str, Any]) -> Dict[str, Any]:
    """Diff a checkpoint against a manifest.

    Returns a report with ``missing`` (expected, absent from the checkpoint),
    ``extra`` (present, not expected), ``shape_mismatch`` ({key:
    {"checkpoint": shape, "manifest": shape}}) and ``ok``. ``module.``
    prefixes are stripped and bookkeeping tensors (``num_batches_tracked``)
    ignored, as a load does."""
    got: Dict[str, Any] = {}
    for k in sd:
        if AUDIT_IGNORE.search(k):
            continue
        kk = k[len("module."):] if k.startswith("module.") else k
        got[kk] = list(getattr(sd[k], "shape", ()))
    want = manifest["keys"]
    missing = sorted(k for k in want if k not in got)
    extra = sorted(k for k in got if k not in want)
    shape_mismatch = {
        k: {"checkpoint": got[k], "manifest": want[k]}
        for k in want
        if k in got and list(got[k]) != list(want[k])
    }
    return {
        "manifest": manifest["name"],
        "expected": len(want),
        "present": len(got),
        "missing": missing,
        "extra": extra,
        "shape_mismatch": shape_mismatch,
        "ok": not missing and not extra and not shape_mismatch,
    }


def format_report(report: Dict[str, Any], max_items: int = 10) -> str:
    """A :func:`verify_state_dict` report as log lines."""
    lines = [
        f"manifest {report['manifest']}: expected {report['expected']} "
        f"tensors, checkpoint has {report['present']}"
    ]

    def _section(title, items):
        if not items:
            return
        lines.append(f"  {title} ({len(items)}):")
        for k in items[:max_items]:
            lines.append(f"    {k}")
        if len(items) > max_items:
            lines.append(f"    ... (+{len(items) - max_items} more)")

    _section("MISSING from checkpoint", report["missing"])
    _section("EXTRA in checkpoint", report["extra"])
    if report["shape_mismatch"]:
        lines.append(f"  SHAPE MISMATCH ({len(report['shape_mismatch'])}):")
        for k, v in list(report["shape_mismatch"].items())[:max_items]:
            lines.append(
                f"    {k}: checkpoint {v['checkpoint']} vs manifest "
                f"{v['manifest']}"
            )
    lines.append("  layout MATCHES the manifest" if report["ok"]
                 else "  layout DIFFERS from the manifest")
    return "\n".join(lines)

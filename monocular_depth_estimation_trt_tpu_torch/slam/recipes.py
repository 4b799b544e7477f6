"""The three SLAM recipes: MegaSaM, ViPE, WildGS-SLAM (counterpart of the
JAX package's ``slam/recipes.py``).

The reference stages these as README-only clone-and-run recipes around
networks the port serves (``later/MegaSaM/README.md`` clones mega-sam with
Depth-Anything + RAFT checkpoints; ``later/VIPE/README.md`` clones NVIDIA's
video pose engine; ``later/WildGS-SLAM/README.md`` clones the Gaussian-splat
SLAM with CUDA rasterizer/lietorch extensions). Each recipe composes the
port's own components:

=============  =====================================================
recipe         composition
=============  =====================================================
megasam        DA-family disparity + RAFT flow -> keyframe LM-BA with
               focal refinement -> consistent video depth (per-frame
               affine alignment through flow; arXiv 2412.04463's CVD)
vipe           GeoCalib intrinsics init + the same flow BA + a metric
               depth channel (UniDepth) that promotes the trajectory
               and depths to meters
wildgs_slam    the BA tracker + uncertainty-weighted Gaussian-splat
               mapping (:mod:`.gaussians`/:mod:`.mapping`) robust to
               dynamic objects (arXiv 2504.03886)
=============  =====================================================

The device work is two engines (``runtime/engine.py``): the LM solve, one
per problem shape (K keyframes, E edges, P grid points), and WildGS-SLAM's
mapping step (forward, backward and Adam update), one per map shape; on the
card each is one captured graph. The recipes differ only in host
orchestration, which is the reference's architecture (driver scripts around
engines). By default they build the port's ``raft`` and
``depth_anything_v2`` vits pipelines (ViPE also ``unidepth_v2`` vitb and
``geocalib``); ``flow_fn``, ``depth_fn``, ``metric_depth_fn`` and
``calib_fn`` inject others.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig, ModelSpec
from monocular_depth_estimation_trt_tpu_torch.runtime.benchmark import BenchmarkReport, benchmark
from monocular_depth_estimation_trt_tpu_torch.runtime.engine import Engine
from monocular_depth_estimation_trt_tpu_torch.runtime.transfer import tree_get_chunked
from monocular_depth_estimation_trt_tpu_torch.slam.ba import (
    BAConfig,
    BAProblem,
    BAState,
    align_disparity,
    init_state,
    run_ba,
)
from monocular_depth_estimation_trt_tpu_torch.slam.frontend import (
    Frontend,
    FrontendConfig,
    _bilinear,
    make_pipeline_depth_fn,
    make_pipeline_flow_fn,
    scale_coords,
)
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log


class SlamResult(NamedTuple):
    keyframe_indices: List[int]
    poses: np.ndarray  # (K, 4, 4) camera-to-world
    focal: float  # refined, in flow-resolution pixels
    keyframe_disparity: List[np.ndarray]  # aligned full-res disparity per kf
    rms_px: float
    extras: Dict[str, Any]


def _default_focal(hw: Tuple[int, int]) -> float:
    # ~53 deg horizontal FoV prior: the standard casual-video assumption
    return 0.9 * max(hw)


def ba_solve_fn(image_hw: Tuple[int, int], cfg: BAConfig) -> Callable:
    """:func:`run_ba` on flat tensors, what the solve's engine captures:
    ``fn(points_uv, idepth, edges, flow, weight, poses, log_scale, shift,
    log_focal, focal_init) -> dict`` of the refined state, ``cost`` and
    ``rms_px``."""

    def fn(*ts):
        state, info = run_ba(BAProblem(*ts[:5]), BAState(*ts[5:9]), ts[9], image_hw, cfg)
        return {**state._asdict(), **info}

    return fn


class _BARecipe:
    """Shared skeleton: frontend -> LM-BA -> aligned keyframe depth."""

    name = "slam"

    def __init__(self, flow_fn: Optional[Callable] = None, depth_fn: Optional[Callable] = None,
                 frontend_cfg: FrontendConfig = FrontendConfig(),
                 ba_cfg: BAConfig = BAConfig(optimize_focal=True), device=None):
        from monocular_depth_estimation_trt_tpu_torch.registry import _full_fp32, resolve_device

        self._flow_fn = flow_fn
        self._depth_fn = depth_fn
        self.frontend_cfg = frontend_cfg
        self.ba_cfg = ba_cfg
        self.device = resolve_device(device)
        _full_fp32(torch.float32, self.device)  # the normal equations in full fp32
        self.spec = ModelSpec(model=self.name, input_hw=(288, 512), precision="fp32")
        self._engines: Dict[Tuple, Engine] = {}

    # lazy heavy deps -----------------------------------------------------
    def _build_deps(self) -> None:
        from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline

        if self._flow_fn is None:
            self._flow_fn = make_pipeline_flow_fn(build_pipeline("raft", device=self.device))
        if self._depth_fn is None:
            self._depth_fn = make_pipeline_depth_fn(
                build_pipeline("depth_anything_v2", encoder="vits", device=self.device))

    def _frontend(self) -> Frontend:
        self._build_deps()
        return Frontend(self._flow_fn, self._depth_fn, self.frontend_cfg)

    def solve_engine(self, image_hw: Tuple[int, int], k: int, e: int, p: int,
                     cfg: Optional[BAConfig] = None) -> Engine:
        """The LM solve's engine for K keyframes, E edges and P grid points
        at flow resolution ``image_hw``: inputs as :func:`ba_solve_fn`'s."""
        cfg = cfg or self.ba_cfg
        key = ("ba", tuple(image_hw), cfg, k, e, p)
        if key not in self._engines:
            meta = dict(dtype=torch.float32, device="meta")
            example = [torch.empty((p, 2), **meta), torch.empty((k, p), **meta),
                       torch.empty((e, 2), dtype=torch.int64, device="meta"),
                       torch.empty((e, p, 2), **meta), torch.empty((e, p), **meta),
                       torch.empty((k, 4, 4), **meta), torch.empty((k,), **meta),
                       torch.empty((k,), **meta), torch.empty((), **meta), torch.empty((), **meta)]
            self._engines[key] = Engine(
                ba_solve_fn(tuple(image_hw), cfg), example, device=self.device,
                name=f"{self.spec.artifact_name()}_ba_k{k}_e{e}_p{p}_{image_hw[0]}x{image_hw[1]}")
        return self._engines[key]

    def release_engines(self) -> None:
        for eng in self._engines.values():
            eng.release()
        self._engines.clear()

    def solve(self, prob: BAProblem, state0: BAState, focal_init: float,
              image_hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
        """The LM solve through its engine: host tensors in, host numpy out."""
        k, (e, p) = state0.poses.shape[0], prob.weight.shape
        eng = self.solve_engine(image_hw, k, e, p)
        out = eng(*prob, *state0, torch.tensor(focal_init, dtype=torch.float32))
        return tree_get_chunked(out)

    # main API ------------------------------------------------------------
    def run(self, frames: Sequence[np.ndarray], focal: Optional[float] = None) -> SlamResult:
        fe = self._frontend()
        kf = fe.select_keyframes(frames)
        log(f"{self.name}: {len(frames)} frames -> {len(kf)} keyframes")
        prob, aux = fe.build_problem(frames, kf)
        fh, fw = aux["flow_hw"]
        focal_init = float(focal) if focal else _default_focal((fh, fw))
        out = self.solve(prob, init_state(len(kf)), focal_init, (fh, fw))
        state = BAState(out["poses"], out["log_scale"], out["shift"], out["log_focal"])
        rms = float(out["rms_px"])
        f_ref = focal_init * float(np.exp(state.log_focal))
        log(f"{self.name}: BA rms {rms:.3f} px, focal {f_ref:.1f} px")
        aligned = [np.exp(state.log_scale[i]) * d + state.shift[i]
                   for i, d in enumerate(aux["full_disparity"])]
        return SlamResult(keyframe_indices=list(kf), poses=np.asarray(state.poses), focal=f_ref,
                          keyframe_disparity=aligned, rms_px=rms,
                          extras={"aux": aux, "state": state, "cost": out["cost"]})

    # consistent video depth (MegaSaM's CVD stage) ------------------------
    def consistent_video_depth(self, frames: Sequence[np.ndarray],
                               result: SlamResult) -> List[np.ndarray]:
        """Per-frame affine alignment of mono disparity against the nearest
        keyframe's BA-consistent depth, matched through dense flow: the
        recipe-level CVD pass. Returns aligned full-res disparity per frame."""
        self._build_deps()
        kfs = result.keyframe_indices
        out: List[np.ndarray] = []
        for i, frame in enumerate(frames):
            nearest = int(np.argmin([abs(i - k) for k in kfs]))
            k_idx = kfs[nearest]
            kf_disp = result.keyframe_disparity[nearest]
            if i == k_idx:
                out.append(kf_disp)
                continue
            disp = np.asarray(self._depth_fn(np.asarray(frame)))
            if not self.frontend_cfg.depth_is_disparity:
                disp = 1.0 / np.maximum(disp, 1e-6)
            disp = disp / (float(np.median(disp)) or 1.0)
            flow = np.asarray(self._flow_fn(np.asarray(frame), np.asarray(frames[k_idx])))
            fh, fw = flow.shape[:2]
            dh, dw = disp.shape[:2]
            st = self.frontend_cfg.grid_stride
            uu, vv = np.meshgrid(np.arange(st // 2, fw, st, dtype=np.float32),
                                 np.arange(st // 2, fh, st, dtype=np.float32))
            pu, pv = uu.ravel(), vv.ravel()
            fg = _bilinear(flow, pu, pv)
            tu, tv = pu + fg[:, 0], pv + fg[:, 1]
            kh, kw = kf_disp.shape[:2]
            tgt_disp = _bilinear(kf_disp, scale_coords(tu, fw, kw), scale_coords(tv, fh, kh))
            own = _bilinear(disp, scale_coords(pu, fw, dw), scale_coords(pv, fh, dh))
            inside = (tu >= 0) & (tu <= fw - 1) & (tv >= 0) & (tv <= fh - 1)
            f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
            s, q = align_disparity(f32(own), 1.0 / torch.clamp(f32(tgt_disp), min=1e-6),
                                   f32(inside))
            out.append(float(s) * disp + float(q))
        return out

    # bench ---------------------------------------------------------------
    def _synthetic_problem(self, in_hw: Tuple[int, int], k: int = 8) -> BAProblem:
        """Deterministic, representative BA problem at in_hw's grid size."""
        st = self.frontend_cfg.grid_stride
        rng = np.random.default_rng(0)
        h, w = in_hw
        uu, vv = np.meshgrid(np.arange(st // 2, w, st, dtype=np.float32),
                             np.arange(st // 2, h, st, dtype=np.float32))
        pts = np.stack([uu.ravel(), vv.ravel()], -1)
        p = pts.shape[0]
        edges = np.asarray([e for i in range(k) for r in (1, 2) if i + r < k
                            for e in ((i, i + r), (i + r, i))], np.int64)
        e = edges.shape[0]
        return BAProblem(
            points_uv=torch.from_numpy(pts),
            idepth=torch.from_numpy(rng.uniform(0.3, 1.5, (k, p)).astype(np.float32)),
            edges=torch.from_numpy(edges),
            flow=torch.from_numpy(rng.normal(0, 4, (e, p, 2)).astype(np.float32)),
            weight=torch.from_numpy(rng.uniform(0.5, 1, (e, p)).astype(np.float32)))

    def benchmark(self, in_hw: Optional[Tuple[int, int]] = None,
                  config: Optional[BenchmarkConfig] = None) -> BenchmarkReport:
        """The recipe's hot path: the LM solve (:meth:`benchmark_solve`, K=8)."""
        return self.benchmark_solve(in_hw, config)

    def benchmark_solve(self, in_hw: Optional[Tuple[int, int]] = None,
                        config: Optional[BenchmarkConfig] = None, k: int = 8) -> BenchmarkReport:
        """Time the LM solve on the served path: a synthetic problem at
        ``in_hw``'s grid size (``k`` keyframes, default 8, in the frontend's
        radius-2 graph: the steady-state tracking workload) from pinned host
        memory, the captured solve, the state and costs D2H into pinned
        buffers."""
        in_hw = tuple(in_hw or self.spec.input_hw)
        prob = self._synthetic_problem(in_hw, k)
        k, (e, p) = prob.idepth.shape[0], prob.weight.shape
        eng = self.solve_engine(in_hw, k, e, p)
        args = [t.pin_memory() for t in (*prob, *init_state(k),
                                          torch.tensor(_default_focal(in_hw)))]
        out = eng(*args)
        host = {n: torch.empty(t.shape, dtype=t.dtype).pin_memory() for n, t in out.items()}

        def step():
            res = eng(*args)
            for n, buf in host.items():
                buf.copy_(res[n], non_blocking=True)

        return benchmark(step, device=self.device, config=config, name=self.spec.artifact_name())

    # the single-image call fails with guidance, not an AttributeError
    def __call__(self, *a, **kw):
        raise RuntimeError(
            f"'{self.name}' is a video SLAM recipe: use `slam {self.name} --video ...` "
            "(python -m monocular_depth_estimation_trt_tpu_torch) or .run(frames) instead of "
            "single-image inference")


class MegaSaMPipeline(_BARecipe):
    """MegaSaM: casual-video structure + motion (``later/MegaSaM/README.md``;
    arXiv 2412.04463). Mono-depth-anchored dense-flow BA with focal
    refinement and flow-consistency motion weights, then consistent video
    depth via per-frame affine alignment."""

    name = "megasam"


class ViPEPipeline(_BARecipe):
    """ViPE: video pose engine (``later/VIPE/README.md``): camera intrinsics
    (GeoCalib), SLAM-scale poses, and METRIC depth per frame. The BA runs in
    relative units; a metric-depth channel (UniDepth by default) then fixes
    the global scale by a robust median ratio over keyframes."""

    name = "vipe"

    def __init__(self, *a, metric_depth_fn: Optional[Callable] = None,
                 calib_fn: Optional[Callable] = None, **kw):
        super().__init__(*a, **kw)
        self._metric_fn = metric_depth_fn
        self._calib_fn = calib_fn

    def _build_metric(self) -> Callable:
        if self._metric_fn is None:
            from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline

            self._metric_fn = make_pipeline_depth_fn(
                build_pipeline("unidepth_v2", encoder="vitb", device=self.device))
        return self._metric_fn

    def _build_calib(self) -> Callable:
        if self._calib_fn is None:
            from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline

            pipe = build_pipeline("geocalib", device=self.device)

            def fn(frame: np.ndarray) -> float:
                return float(np.asarray(pipe(frame)["focal"]))

            self._calib_fn = fn
        return self._calib_fn

    def run(self, frames: Sequence[np.ndarray], focal: Optional[float] = None) -> SlamResult:
        if focal is None:
            f_img = self._build_calib()(np.asarray(frames[0]))
            # GeoCalib reports the focal in pixels of the image; the BA wants
            # flow-resolution pixels: probe the flow net's output shape
            self._build_deps()
            f0 = np.asarray(frames[0])
            focal = f_img * (np.asarray(self._flow_fn(f0, f0)).shape[0] / f0.shape[0])
            log(f"vipe: GeoCalib focal {f_img:.1f} px (image) -> {focal:.1f} px (flow res)")
        res = super().run(frames, focal=focal)

        # metric promotion: median ratio between metric depth and BA depth
        metric = self._build_metric()
        ratios = []
        for n, k_idx in enumerate(res.keyframe_indices):
            md = np.asarray(metric(np.asarray(frames[k_idx])))
            ba_depth = 1.0 / np.maximum(res.keyframe_disparity[n], 1e-6)
            bh, bw = ba_depth.shape[:2]
            if md.shape != ba_depth.shape:
                yy = (np.arange(bh) + 0.5) * (md.shape[0] / bh) - 0.5
                xx = (np.arange(bw) + 0.5) * (md.shape[1] / bw) - 0.5
                md = _bilinear(md, *np.meshgrid(xx, yy))
            valid = (md > 1e-3) & (ba_depth > 1e-3) & (ba_depth < 1e3)
            if valid.sum() > 16:
                ratios.append(np.median(md[valid] / ba_depth[valid]))
        scale = float(np.median(ratios)) if ratios else 1.0
        log(f"vipe: metric scale {scale:.3f}")
        poses = res.poses.copy()
        poses[:, :3, 3] *= scale
        extras = {**res.extras, "metric_scale": scale}
        return res._replace(poses=poses, keyframe_disparity=[d / scale for d in
                                                             res.keyframe_disparity],
                            extras=extras)


class WildGSSLAMPipeline(_BARecipe):
    """WildGS-SLAM: the BA tracker + uncertainty-weighted Gaussian-splat
    mapping (``later/WildGS-SLAM/README.md``; arXiv 2504.03886). Dynamic
    content is suppressed twice: flow-consistency weights in tracking,
    learned per-pixel uncertainty in mapping. ``uncertainty_init``: the
    uncertainty net's starting state dict (default: random weights from a
    seeded generator, seed 0)."""

    name = "wildgs_slam"
    UNC_WIDTH = 16

    def __init__(self, *a, map_hw: Tuple[int, int] = (144, 256), max_gaussians: int = 32768,
                 mapping_iters: int = 40, k_per_tile: int = 32,
                 uncertainty_init: Optional[Dict[str, torch.Tensor]] = None, **kw):
        super().__init__(*a, **kw)
        self.map_hw = tuple(map_hw)
        self.max_gaussians = max_gaussians
        self.mapping_iters = mapping_iters
        self.k_per_tile = k_per_tile
        self.uncertainty_init = uncertainty_init

    def _mapper(self):
        """The uncertainty net (on the device) and the mapping step."""
        from monocular_depth_estimation_trt_tpu_torch.slam.mapping import (
            MappingConfig,
            UncertaintyNet,
            make_mapping_step,
        )
        from monocular_depth_estimation_trt_tpu_torch.weights.store import init_random_

        net = UncertaintyNet(width=self.UNC_WIDTH)
        if self.uncertainty_init is None:
            init_random_(net, seed=0)
        else:
            net.load_state_dict(self.uncertainty_init)
        net = net.to(self.device)
        return net, make_mapping_step(net, MappingConfig(k_per_tile=self.k_per_tile))

    def mapping_engine(self, step: Callable, state: List[torch.Tensor], names: Sequence[str],
                       map_hw: Tuple[int, int]) -> Engine:
        """The mapping step's engine at ``map_hw``: the flat state
        (:func:`flatten_mapping_state`) and the frame's rgb, depth anchor,
        pose and focal in; the new flat state and the loss out."""
        g = state[0].shape[0]
        key = ("map", tuple(map_hw), g, self.k_per_tile)
        if key not in self._engines:
            mh, mw = map_hw
            example = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in state]
            example += [torch.empty((mh, mw, 3), device="meta"),
                        torch.empty((mh, mw), device="meta"),
                        torch.empty((4, 4), device="meta"), torch.empty((), device="meta")]

            def fn(*ts):
                g2, u2, o2, loss, _ = step(*unflatten_mapping_state(ts[:-4], names), *ts[-4:])
                return [*flatten_mapping_state(g2, u2, o2), loss]

            self._engines[key] = Engine(fn, example, device=self.device,
                                        name=f"{self.spec.artifact_name()}_map_{mh}x{mw}_g{g}")
        return self._engines[key]

    def run(self, frames: Sequence[np.ndarray], focal: Optional[float] = None) -> SlamResult:
        from monocular_depth_estimation_trt_tpu_torch.slam.gaussians import (
            GaussianMap,
            init_from_depth,
            insert_gaussians,
            render,
        )

        res = super().run(frames, focal=focal)
        mh, mw = self.map_hw
        fh, fw = res.extras["aux"]["flow_hw"]
        f_map = res.focal * (mh / fh)
        dev = self.device

        def to_map_res(img: np.ndarray) -> torch.Tensor:
            h, w = img.shape[:2]
            yy = (np.arange(mh) + 0.5) * (h / mh) - 0.5
            xx = (np.arange(mw) + 0.5) * (w / mw) - 0.5
            return torch.from_numpy(np.asarray(_bilinear(img, *np.meshgrid(xx, yy)),
                                               np.float32)).to(dev)

        net, (init_opt, step) = self._mapper()
        names = [n for n, _ in net.named_parameters()]
        focal_t = torch.tensor(f_map, dtype=torch.float32).to(dev)
        gmap = state = None
        rgbs, depths, poses = [], [], []
        loss = torch.tensor(float("nan"))  # mapping_iters=0: no loss yet
        with torch.no_grad():
            for n, k_idx in enumerate(res.keyframe_indices):
                rgb = to_map_res(np.asarray(frames[k_idx]).astype(np.float32) / 255.0)
                depth = to_map_res(1.0 / np.maximum(res.keyframe_disparity[n], 1e-4))
                pose = torch.from_numpy(np.asarray(res.poses[n], np.float32)).to(dev)
                seed = init_from_depth(rgb, depth, pose, f_map, stride=4,
                                       max_gaussians=self.max_gaussians // 4)
                if gmap is None:  # capacity-stable map container
                    pad = self.max_gaussians - seed.means.shape[0]
                    gmap = GaussianMap(*(torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
                                         for x in seed))
                    unc = {k: v.detach().clone() for k, v in net.named_parameters()}
                    state = flatten_mapping_state(gmap, unc, init_opt(gmap, unc))
                else:
                    gmap = insert_gaussians(GaussianMap(*state[:6]), seed)
                    state = [*gmap, *state[6:]]
                rgbs.append(rgb)
                depths.append(depth)
                poses.append(pose)
                # optimize over the keyframe window (round-robin)
                for it in range(self.mapping_iters):
                    j = it % len(rgbs)
                    *state, loss = self.mapping_engine(step, state, names, self.map_hw)(
                        *state, rgbs[j], depths[j], poses[j], focal_t)
            gmap, unc, _ = unflatten_mapping_state(state, names)
            log(f"wildgs_slam: map {int(gmap.valid.sum())} gaussians, final mapping loss "
                f"{float(loss):.4f}")
            rendered = [render(gmap, poses[n], focal_t, (mh, mw),
                               k_per_tile=self.k_per_tile).depth.cpu().numpy()
                        for n in range(len(poses))]
        extras = {**res.extras,
                  "gaussians": GaussianMap(*(t.cpu().numpy() for t in gmap)),
                  "uncertainty_params": {k: v.cpu().numpy() for k, v in unc.items()},
                  "rendered_depth": rendered, "map_hw": self.map_hw, "map_focal": f_map}
        return res._replace(extras=extras)

    def benchmark(self, in_hw: Optional[Tuple[int, int]] = None,
                  config: Optional[BenchmarkConfig] = None) -> BenchmarkReport:
        """Time one mapping step (render + backward + Adam) at ``in_hw`` with
        the full static gaussian capacity, as the recipe's loop serves it:
        the state resident on the device, the captured step, the loss D2H
        (the reference recipe's CUDA rasterizer role)."""
        from monocular_depth_estimation_trt_tpu_torch.slam.gaussians import init_from_depth

        in_hw = tuple(in_hw or self.map_hw)
        h, w = in_hw[0] - in_hw[0] % 16, in_hw[1] - in_hw[1] % 16
        rng = np.random.default_rng(0)
        dev = self.device
        depth = torch.from_numpy(2.0 + rng.random((h, w)).astype(np.float32)).to(dev)
        rgb = torch.from_numpy(rng.random((h, w, 3)).astype(np.float32)).to(dev)
        pose = torch.eye(4, device=dev)
        focal = torch.tensor(_default_focal((h, w)), dtype=torch.float32).to(dev)
        gmap = init_from_depth(rgb, depth, pose, focal, stride=2, max_gaussians=self.max_gaussians)
        net, (init_opt, step) = self._mapper()
        unc = {k: v.detach().clone() for k, v in net.named_parameters()}
        state = flatten_mapping_state(gmap, unc, init_opt(gmap, unc))
        eng = self.mapping_engine(step, state, list(unc), (h, w))
        host = torch.empty((), dtype=torch.float32).pin_memory()

        def one():
            host.copy_(eng(*state, rgb, depth, pose, focal)[-1], non_blocking=True)

        return benchmark(one, device=dev, config=config, name=self.spec.artifact_name())


def flatten_mapping_state(gmap, unc: Dict[str, torch.Tensor], opt) -> List[torch.Tensor]:
    """(GaussianMap, uncertainty params, MappingOptState) -> one list of
    tensors: the map's 6, the net's parameters, then each Adam group's count,
    first and second moments."""
    return [*gmap, *unc.values(),
            opt.gauss.count, *opt.gauss.mu, *opt.gauss.nu,
            opt.unc.count, *opt.unc.mu, *opt.unc.nu]


def unflatten_mapping_state(ts: Sequence[torch.Tensor], names: Sequence[str]):
    """The inverse of :func:`flatten_mapping_state` (``names``: the net's
    parameter names, in order)."""
    from monocular_depth_estimation_trt_tpu_torch.slam.gaussians import GaussianMap
    from monocular_depth_estimation_trt_tpu_torch.slam.mapping import AdamState, MappingOptState

    ng, nu = 6, len(names)
    gmap = GaussianMap(*ts[:ng])
    unc = dict(zip(names, ts[ng:ng + nu]))
    rest = list(ts[ng + nu:])
    groups = []
    for n in (ng, nu):
        groups.append(AdamState(rest[0], tuple(rest[1:1 + n]), tuple(rest[1 + n:1 + 2 * n])))
        rest = rest[1 + 2 * n:]
    return gmap, unc, MappingOptState(*groups)

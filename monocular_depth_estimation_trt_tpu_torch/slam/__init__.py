"""SLAM-scale video geometry recipes (MegaSaM / ViPE / WildGS-SLAM), the
counterpart of the JAX package's ``slam/``.

The reference stages these three as README-only clone-and-run recipes
(``later/MegaSaM/README.md``, ``later/VIPE/README.md``,
``later/WildGS-SLAM/README.md``); both packages build them from their own
components:

* :mod:`.lie` — SO(3)/SE(3) closed forms.
* :mod:`.ba` — dense-flow bundle adjustment: one Levenberg-Marquardt solve
  (poses, per-keyframe disparity scale/shift, optional focal), captured as
  one engine per problem shape on the card.
* :mod:`.frontend` — keyframing, pair graphs, batched depth/flow inference
  (host numpy).
* :mod:`.gaussians` — a differentiable 3D Gaussian-splat renderer;
  :mod:`.mapping` — the uncertainty-weighted mapping step (one engine).
* :mod:`.recipes` — the pipelines; ``megasam`` / ``vipe`` / ``wildgs_slam``
  in ``registry.py``.
"""

"""The spec-conformant AV1 codec: host code (numpy and the C++ helpers
of ``native``), the port's own copy of the JAX package's
``codec/av1``.

``rdsearch_device`` is the RD pre-pass as a PyTorch program on the
encoder's device; ``rdsearch.plan_luma`` reaches it as
``from . import rdsearch_device``. The inter path (``interenc``,
``interpred``, ``inter``, ``interdec``, ``mvpred``, ``mvproj``, ``obmc``,
``warp``, ``refs``, ``stream``, ``superres``) plans each frame on the
host; ``interenc``'s ``from ..frame import _looks_like_screen_content``
resolves to ``libavif_tpu_torch.codec.frame``, and the planner of each
of its frames asks ``rdsearch_device.plan_costs_device`` for the RD
pre-pass, which runs on the device the port's ``encode_sequence_frames``
holds for it (``held_for_planner``).
"""

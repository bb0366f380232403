"""The command-line tools on the port: ``python -m
libavif_tpu_torch.cli.avifenc``, ``avifdec`` and ``gainmaputil``.

The three tools are copies of the JAX package's; their ``..api``,
``..io_formats``, ``..hdr`` and ``..pixels`` are the port's, so every
encode, decode and conversion runs on ``default_device()``.
"""

"""PyTorch/CUDA port of the range-view 3D detector: serving, training
and the training loop (``train``, ``evaluate`` and ``overfit`` entry
points), and the offline converters of raw logs (``converters/``).

Mirrors ``range_view_3d_detection_tpu``'s layout (``models/``, ``ops/``,
``kernels/``, ``training/``, ``data/``, ``evaluation/``, ``utils/``) and
imports nothing from it: the JAX package is the
reference the port is tested against, not a dependency. Public functions
keep the JAX package's channel-last layout; modules run NCHW tensors in
``torch.channels_last`` memory internally.
"""

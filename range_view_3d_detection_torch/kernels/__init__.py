"""Hand-written Hopper kernels (``csrc/*.cu``) and their plain twins.

Each wrapper takes its plain PyTorch twin only for CPU tensors; for a
CUDA tensor it launches the kernel or raises. Importing this package
registers the four kernels as ``torch.library`` custom ops
(``rv3d::meta_kernel_fused``, ``rv3d::nms_scan``, ``rv3d::conv3x3_i8``,
``rv3d::meta_kernel_fused_i8``) and the served program's result types as
pytrees, which is all that loading an AOT artifact needs; nothing is
built until a kernel's first launch.
"""

from range_view_3d_detection_torch import results  # noqa: F401
from range_view_3d_detection_torch.kernels import conv, nms, stem  # noqa: F401

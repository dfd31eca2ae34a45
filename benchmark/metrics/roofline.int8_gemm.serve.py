"""K8 and K9 (``ops/int8_linear.py``) in the traced slice: the summed least
times of the launched shapes that their spans name over the summed device
time of the ``srgpt::qgemm::`` kernels they pair with, in percent
(``spans.int8_gemm_roofline``)."""

from spans import int8_gemm_roofline as read  # noqa: F401

"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
700 W power limit), the yardstick of every roofline share here.  Frozen:
a later change to a kernel cannot change what it is measured against."""

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

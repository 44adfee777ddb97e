"""int4-weight matmul with BFP fixed-point accumulation (paper §4.2):
x [M, K] (bf16/fp32) × int4 codes [Kw >= K, N] (int8 storage in [-8, 7])
with per-group scales [Kw/G, N] -> [M, N] in x's dtype.

Kernel: ``csrc/fused_linear_int4.cu`` (CUDA C++, sm_90a), the port of
``int4_matmul_pallas`` in the JAX package's ``kernels/int4_matmul.py``:
the int4 fused pipeline with no prologue and no epilogue, on the route
``fused_linear.plan_int4`` picks (the split-K code stream for the lm head,
whose M is the batch; the s8 tensor-core tile above 16 rows).  At decode
it is bound by the codes' bytes.  The plain version is
``ref.bfp_matmul_ref`` (the BFP product, not an exact dequantization; with
the plan's ``split_groups`` on the stream, its order of the group terms).

``int4_matmul`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; any other device, or a failed build or launch,
raises.  ``launches`` counts calls, ``launches_tc`` and ``launches_stream``
the route each took.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_linear as fl
from repro_torch.kernels import ref

launches = 0
launches_tc = 0
launches_stream = 0


def int4_matmul(x: torch.Tensor, w_codes: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.bfp_matmul_ref(x, w_codes, scale)
    return int4_matmul_cuda(x, w_codes, scale)


def int4_matmul_cuda(x: torch.Tensor, w_codes: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """The CUDA kernels alone (raises for anything they do not take)."""
    global launches, launches_tc, launches_stream
    G, C = fl.check_codes(x, w_codes, scale)
    M, K = x.shape
    p = fl.plan_int4(M, K, w_codes.shape[1], G, C, False, x.dtype)
    out, _ = fl.run_plan_int4(p, x, w_codes, scale)
    launches += 1
    if p.route == "tc":
        launches_tc += 1
    else:
        launches_stream += 1
    return out

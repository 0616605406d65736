"""CodedLinear: FCDCC applied to dense (1x1-conv) layers.

A linear layer ``Y = X W`` is the K_H = K_W = s = 1 case of the
convolution: KCCP partitions W along its output dim into k_b coded parts,
APCP degenerates to disjoint row (token) partitioning of X into k_a parts,
and the same CRME encode / any-delta decode applies.  This is how coded
projection and FFN layers of an LM are protected against stragglers.

On the card a worker's product runs as one GEMM on K2 (``kernels/matmul``,
the op the LM worker uses) and the survivor decode on K3 (``crme_decode``)
with the decode inverse on the host; CPU tensors take their plain
versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.coded_gemm import coded_gemm, crme_decode
from ..kernels.coded_gemm.kernel import R_MAX
from ..kernels.matmul import matmul
from .crme import recovery_matrix
from .fcdcc import FcdccPlan
from .nsctc import encode_tensor_list, group_by_worker

__all__ = ["CodedLinear"]


class CodedLinear:
    """Straggler-coded ``Y = X @ W``.

    ``X``: (T, d_in) split into k_a row blocks; ``W``: (d_in, d_out) split
    into k_b column blocks.  Each of n workers multiplies its ell_a coded
    row blocks with its ell_b coded column blocks; any delta workers
    reconstruct Y exactly.
    """

    def __init__(self, plan: FcdccPlan, t: int, d_in: int, d_out: int):
        if t % plan.k_a or d_out % plan.k_b:
            raise ValueError(f"T={t} must divide by k_a={plan.k_a} and "
                             f"d_out={d_out} by k_b={plan.k_b}")
        self.plan = plan
        self.a_code, self.b_code = plan.codes
        self.t, self.d_in, self.d_out = t, d_in, d_out
        self.tb = t // plan.k_a
        self.ob = d_out // plan.k_b
        self.weight_encode_calls = 0
        self._we_src = None  # identity key of the cached coded weights
        self._we = None
        self._decode_cache: dict = {}  # survivor subset -> Q x Q inverse

    # -- master -----------------------------------------------------------
    def encode_inputs(self, x: torch.Tensor) -> torch.Tensor:
        parts = x.reshape(self.plan.k_a, self.tb, self.d_in)
        coded = encode_tensor_list(parts, self.a_code.matrix)
        return group_by_worker(coded, self.a_code.ell)  # (n, ell_a, tb, d_in)

    def encode_weights(self, w: torch.Tensor) -> torch.Tensor:
        self.weight_encode_calls += 1
        parts = w.reshape(self.d_in, self.plan.k_b, self.ob).transpose(0, 1)
        coded = encode_tensor_list(parts, self.b_code.matrix)
        return group_by_worker(coded, self.b_code.ell)  # (n, ell_b, d_in, ob)

    # -- worker -----------------------------------------------------------
    def worker_compute(self, xe_i: torch.Tensor, we_i: torch.Tensor) -> torch.Tensor:
        """(ell_a, tb, d_in) x (ell_b, d_in, ob) -> (ell_a*ell_b, tb, ob),
        slot ``ell_b*a + b``: every pairwise product at once as one
        (ell_a*tb, d_in) @ (d_in, ell_b*ob) GEMM."""
        ea, eb = self.plan.ell_a, self.plan.ell_b
        a = xe_i.reshape(ea * self.tb, self.d_in).contiguous()
        b = we_i.transpose(0, 1).reshape(self.d_in, eb * self.ob).contiguous()
        y = matmul(a, b).reshape(ea, self.tb, eb, self.ob)
        return y.transpose(1, 2).reshape(ea * eb, self.tb, self.ob)

    # -- master: decode ---------------------------------------------------
    def decode_matrix(self, worker_ids) -> np.ndarray:
        """Host-side Q x Q decode inverse (fp32) for a survivor subset,
        cached per subset."""
        key = tuple(worker_ids)
        d = self._decode_cache.get(key)
        if d is None:
            e = recovery_matrix(self.a_code, self.b_code, list(key))
            d = self._decode_cache[key] = np.linalg.inv(e.T).astype(np.float32)
        return d

    def decode(self, worker_ids, outputs: torch.Tensor, decode_inverse=None) -> torch.Tensor:
        """Reconstruct Y from the fastest delta workers' outputs
        ``(delta, ell_a*ell_b, tb, ob)``; ``decode_inverse`` (host, Q x Q)
        defaults to the cached one of the subset."""
        if decode_inverse is None:
            decode_inverse = self.decode_matrix(worker_ids)
        q = self.plan.k_a * self.plan.k_b
        rows = outputs.reshape(q, self.tb * self.ob).contiguous()
        d = torch.as_tensor(decode_inverse, dtype=rows.dtype)  # on the host
        blocks = _decode_rows(d, rows)
        grid = blocks.reshape(self.plan.k_a, self.plan.k_b, self.tb, self.ob)
        return grid.permute(0, 2, 1, 3).reshape(self.t, self.d_out)

    def encoded_weights(self, w: torch.Tensor) -> torch.Tensor:
        """Encode-once cache keyed on the weight tensor's identity."""
        if self._we_src is not w:
            self._we = self.encode_weights(w)
            self._we_src = w
        return self._we

    def run_simulated(self, x, w, worker_ids=None, decode_inverse=None) -> torch.Tensor:
        ids = list(range(self.plan.delta)) if worker_ids is None else list(worker_ids)
        xe = self.encode_inputs(x)
        we = self.encoded_weights(w)
        outs = torch.stack([self.worker_compute(xe[i], we[i]) for i in ids])
        return self.decode(ids, outs, decode_inverse)


def _decode_rows(d: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``d (Q, Q) @ rows (Q, F)`` on K3, which takes code matrices of up to
    ``R_MAX`` rows and columns: a larger Q runs as blocks of that size,
    each a K3 launch, summed along the columns."""
    q = d.shape[0]
    if q <= R_MAX:
        return crme_decode(d, rows)
    out = []
    for r0 in range(0, q, R_MAX):
        acc = None
        for c0 in range(0, q, R_MAX):
            part = coded_gemm(d[r0:r0 + R_MAX, c0:c0 + R_MAX].contiguous(),
                              rows[c0:c0 + R_MAX])
            acc = part if acc is None else acc + part
        out.append(acc)
    return torch.cat(out)

"""Adam with bf16 moments and / or an f32 master of bf16 weights: a
multi-tensor CUDA kernel for Hopper (``csrc/adam.cu``), its plain PyTorch
version, and its launch counter.

Port-only: the JAX package's Adam is XLA, no ``pallas_call``. The kernel is
the update of whichever JAX optimizer ``train.adam_mu_dtype``,
``train.adam_nu_dtype`` and ``train.param_dtype`` select
(``gasfm_tpu/train/state.py`` ``build_optimizer`` :159-210):

- ``nu`` bf16: the clone ``_scale_by_adam_cast`` (:29), its moments upcast
  before the decay, ``mu' = b1 * mu + (1 - b1) * g``,
  ``nu' = b2 * nu + (1 - b2) * g * g``;
- ``nu`` f32: ``optax.adam(mu_dtype=...)``, ``mu' = (1 - b1) * g + b1 * mu``,
  where with a bf16 ``mu`` the product is bf16: ``b1`` is bf16(0.9) =
  0.8984375, and the product is rounded to bf16 before the f32 add (the
  program's semantics, which JAX computes op by op; XLA's CPU compiler, under
  jit, keeps that product in f32 and contracts the add to an FMA);

then with the bias corrections of ``count + 1`` and the rate ``lr`` (a 0-d
float32 tensor on the device), ``p' = p + (-lr) * ((mu' / bc1) / (sqrt(nu' /
bc2) + eps))``, the moments stored in their dtypes. ``p`` is the f32
parameter, or with bf16 weights the f32 master, whose bf16 rounding is also
written to the model's parameter in place (the JAX wrapper
``_with_f32_master`` :86, whose updates are the new parameters).

:class:`AdamBuffers` holds the state an update writes: the parameters (or
the master and the model's bf16 copies), the moments, Adam's count (an int32
0-d tensor, as optax's) and, on the card, the pointer and chunk tables the
kernel reads, built once, so that the launch records into a CUDA graph. The
gradients' addresses go in the launch's parameters, at most
``MAX_TENSORS`` tensors per launch (the flagship's 673 take one).

A CPU tensor runs the plain version (the same formula as per-tensor torch
ops, each rounded as the kernel's ``_rn`` intrinsics); a CUDA tensor
launches the kernel or raises. ``adam_update.launches`` counts the
launches. The plain version run on the card agrees with the kernel bitwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from gasfm_tpu_torch.ops.kernels import build as kb

B1, B2, EPS = 0.9, 0.999, 1e-8
B1_BF16 = 0.8984375  # bf16(0.9): a Python float times a bf16 tensor, in JAX
INT32_MAX = 2 ** 31 - 1
MAX_TENSORS = 1024  # kMaxTensors of csrc/adam.cu
CHUNK = 16384  # elements of one tensor per chunk (a block's unit of work)
BLOCKS_PER_SM = 8


@functools.lru_cache(maxsize=None)
def _entry():
    # mu_bf16, nu_bf16, g_bf16, master, grad_ptrs, first_tensor, n_tensors, table,
    # chunks, n_chunks, chunk, count, ticket, lr, write_count, grid, stream
    return kb.bind(kb.load("adam"), "gasfm_adam",
                   (kb.I, kb.I, kb.I, kb.I, kb.P, kb.I, kb.I, kb.P, kb.P, kb.I, kb.I, kb.P, kb.P,
                    kb.P, kb.I, kb.I, kb.P))


class AdamBuffers:
    """What one Adam update reads and writes, on the parameters' device:
    ``params`` the f32 tensors the update applies to (the model's parameters,
    or with ``master`` an f32 copy of the model's bf16 ones, made from them:
    the JAX wrapper's master starts from the bf16-rounded weights), ``copies``
    the model's bf16 parameters under ``master`` (else None), ``mu`` and
    ``nu`` zeros in ``mu_dtype`` / ``nu_dtype``, ``count`` Adam's int32
    count. On the card also the kernel's tables (see the module docstring)."""

    def __init__(self, params: Sequence[torch.Tensor], mu_dtype: torch.dtype,
                 nu_dtype: torch.dtype, master: bool):
        params = [p.detach() for p in params]
        device = params[0].device
        if master:
            if any(p.dtype != torch.bfloat16 for p in params):
                raise TypeError("an f32 master steps bf16 parameters")
            self.copies: Optional[List[torch.Tensor]] = params
            self.params = [p.float() for p in params]
        else:
            if any(p.dtype != torch.float32 for p in params):
                raise TypeError("Adam without a master steps float32 parameters")
            self.copies, self.params = None, params
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=nu_dtype) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.mu_bf16 = mu_dtype == torch.bfloat16
        self.nu_bf16 = nu_dtype == torch.bfloat16
        self.master = master
        if device.type == "cuda":
            self._build_tables(device)

    def _build_tables(self, device: torch.device) -> None:
        """The per-tensor table (f32 target, bf16 copy, mu, nu, size; five
        int64 each, the kernel's AdamTensor), the chunk table ((tensor,
        first element) int32 pairs, in tensor order), the launches' ranges
        of both, and the count's ticket."""
        rows, chunks = [], []
        for i, p in enumerate(self.params):
            copy = self.copies[i] if self.copies is not None else None
            rows.append([p.data_ptr(), 0 if copy is None else copy.data_ptr(),
                         self.mu[i].data_ptr(), self.nu[i].data_ptr(), p.numel()])
            chunks += [(i, s) for s in range(0, p.numel(), CHUNK)]
        self.table = torch.tensor(np.asarray(rows, dtype=np.int64), device=device)
        self.chunks = torch.tensor(np.asarray(chunks, dtype=np.int32).reshape(-1, 2),
                                   device=device)
        self.ticket = torch.zeros((), dtype=torch.int32, device=device)
        first_chunk = np.searchsorted(np.asarray([c[0] for c in chunks]),
                                      np.arange(0, len(self.params) + 1, MAX_TENSORS))
        self.launches = []  # (first tensor, n tensors, first chunk, n chunks)
        for k, t0 in enumerate(range(0, len(self.params), MAX_TENSORS)):
            c0 = int(first_chunk[k])
            c1 = int(first_chunk[k + 1]) if k + 1 < len(first_chunk) else len(chunks)
            self.launches.append((t0, min(MAX_TENSORS, len(self.params) - t0), c0, c1 - c0))


def _bias_corrections(count: torch.Tensor):
    """(count + 1 saturating at the int32 maximum, 1 - b1^(count + 1),
    1 - b2^(count + 1)) in float32, on count's device."""
    c = torch.where(count < INT32_MAX, count + 1, count)
    cf = c.float()
    b1 = torch.full((), B1, dtype=torch.float32, device=count.device)
    b2 = torch.full((), B2, dtype=torch.float32, device=count.device)
    return c, 1 - b1 ** cf, 1 - b2 ** cf


def moments_plain(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor):
    """(mu', nu') in float32 of one tensor: the formula of the JAX branch
    that ``m`` and ``v``'s dtypes select (module docstring), ``g`` float32."""
    m32, v32 = m.float(), v.float()
    gg = g * g
    if v.dtype == torch.bfloat16:  # _scale_by_adam_cast
        return B1 * m32 + (1 - B1) * g, B2 * v32 + (1 - B2) * gg
    bm = (B1_BF16 * m32).bfloat16().float() if m.dtype == torch.bfloat16 else B1 * m32
    return (1 - B1) * g + bm, (1 - B2) * gg + B2 * v32


@torch.no_grad()
def adam_update_plain(grads: Sequence[torch.Tensor], buf: AdamBuffers, lr: torch.Tensor) -> None:
    """Plain version: one update of ``buf`` from ``grads`` (one per tensor,
    float32, or bf16 under the master) with the rate ``lr``, in place."""
    c, bc1, bc2 = _bias_corrections(buf.count)
    neg_lr = -lr
    for i, g in enumerate(grads):
        m1, v1 = moments_plain(g.float(), buf.mu[i], buf.nu[i])
        den = torch.sqrt(v1 / bc2) + EPS
        p1 = buf.params[i] + neg_lr * ((m1 / bc1) / den)
        buf.mu[i].copy_(m1)
        buf.nu[i].copy_(v1)
        buf.params[i].copy_(p1)
        if buf.copies is not None:
            buf.copies[i].copy_(p1)
    buf.count.copy_(c)


def _check_grads(grads: Sequence[torch.Tensor], buf: AdamBuffers) -> List[torch.Tensor]:
    if len(grads) != len(buf.params):
        raise ValueError(f"adam_update: {len(grads)} gradients for {len(buf.params)} tensors")
    out = []
    g_dtype = grads[0].dtype if grads else torch.float32
    allowed = (torch.float32, torch.bfloat16) if buf.master else (torch.float32,)
    for g, p in zip(grads, buf.params):
        if g.dtype != g_dtype or g.dtype not in allowed or not g.is_cuda:
            raise TypeError(f"adam_update: expected {allowed} CUDA gradients of one dtype, got "
                            f"{g.dtype} on {g.device}")
        if g.shape != p.shape:
            raise ValueError(f"adam_update: gradient of shape {tuple(g.shape)} for a tensor of "
                             f"shape {tuple(p.shape)}")
        out.append(g.contiguous())
    return out


def adam_update_cuda(grads: Sequence[torch.Tensor], buf: AdamBuffers, lr: torch.Tensor) -> None:
    """Launch the kernel (CUDA tensors): one launch per ``MAX_TENSORS``
    tensors, the last one writing the count."""
    grads = _check_grads(grads, buf)
    lr = kb.cuda_f32("lr", lr, ())
    dev = buf.count.device
    g_bf16 = int(bool(grads) and grads[0].dtype == torch.bfloat16)
    for k, (t0, nt, c0, nc) in enumerate(buf.launches):
        ptrs = (ctypes.c_void_p * nt)(*[g.data_ptr() for g in grads[t0:t0 + nt]])
        grid = max(1, min(nc, BLOCKS_PER_SM * kb.sm_count(dev.index)))
        code = _entry()(int(buf.mu_bf16), int(buf.nu_bf16), g_bf16, int(buf.master),
                        ctypes.cast(ptrs, ctypes.c_void_p), t0, nt, buf.table.data_ptr(),
                        buf.chunks[c0:].data_ptr(), nc, CHUNK, buf.count.data_ptr(),
                        buf.ticket.data_ptr(), lr.data_ptr(), int(k == len(buf.launches) - 1),
                        grid, kb.stream(dev))
        kb.check(code, "adam_update")
        adam_update.launches += 1


def adam_update(grads: Sequence[torch.Tensor], buf: AdamBuffers, lr: torch.Tensor) -> None:
    """One Adam update of ``buf`` from ``grads`` with the rate ``lr``, in
    place: the kernel on the card, its plain version on the CPU."""
    if buf.count.device.type == "cpu":
        adam_update_plain(grads, buf, lr)
    else:
        adam_update_cuda(grads, buf, lr)


adam_update.launches = 0

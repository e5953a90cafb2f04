"""The RWKV6 (WKV) recurrence on Hopper: the time mix of the rwkv6 family.

Replaces the Pallas TPU kernel ``wkv6`` (``src/repro/kernels/wkv6.py:70``,
body ``_kernel``); the CUDA source is ``csrc/wkv6.cu``. Per batch row and
head, with a ``(K, K)`` f32 state ``S`` carried over the steps::

    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T        (w clipped to [1e-12, 1])

Two kernels, chosen by shape only. For ``T >= 2`` one block of 8 warps
per (row, head) walks the sequence in chunks of 32 steps with the state in
shared memory, the TPU kernel's chunked form: per chunk, the decayed
``r k^T`` triangle, ``o = (r e^{L}) S + att v`` and the state update run on
the tensor cores as 3xTF32 (``mma.sync`` m16n8k8, f32-accurate), with
r/k/w/v copied in by 16-byte ``cp.async`` while the previous chunk
computes. The triangle's decay factors are centred per channel on the
chunk's own log-decay while it spans at most 60 (always, under the
model's clip); a steeper channel splits them at the end of the first
16-step sub-block, and the two diagonal sub-blocks then take each pair's
weight directly. So the kernel is finite over the whole clipped range
``[1e-12, 1]``, where the TPU kernel's half-chunk centring overflows (w <=
1e-3 at chunk 32). For ``T == 1`` (a decode step) a step kernel splits each
(row, head) into 32-column slabs of the state, one warp a slab and one
column a thread. ``chunk`` only keeps the reference's length contract (``T`` a
multiple of ``min(chunk, T)``); the kernel's own chunk is internal and a
tail chunk is masked. r/k/v/w are read in place through their strides
(last dimension contiguous): the TPU wrapper's move to ``(B, H, T, K)`` is
no copy here. For ``T >= 2`` each row of r/k/v/w must start 16-byte
aligned, and the state must be 16-byte aligned.

What bounds it on the H100: bytes. A prefill of B 8, T 1,024, H 32, K 64
in bf16 moves ≈ 243 MB (≈ 0.073 ms at 3.35 TB/s, reckoned) for ≈ 5.4
GFLOP (≈ 19 GFLOP of 3xTF32 tensor-core work in the chunked form); a
decode step moves the state (≈ 8.4 MB at B 8). PERF.md records the times
against the bound.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.wkv6_ref`; on a fake one, the dry run's,
the chunked plain form); on a CUDA tensor it launches the kernel or
raises. ``.launches`` counts launches.

Gradient: where grad mode is on and an input requires grad, the call on
the card goes through :class:`_WKV6`, whose forward is the kernel and
whose backward recomputes the chunked plain form
(:func:`repro_torch.kernels.ref.wkv6_chunked`, chunk ``min(chunk, T)``;
the step-by-step ``wkv6_ref`` loops over T) and returns autograd's
gradient of both outputs, ``o`` and the final state: the gradient XLA
takes of the JAX model's own ``wkv6_chunked``, including its limit (its
half-chunk centring overflows f32 where a chunk's log-decay sums past
≈ 177, far outside the model's decay clip). A direct launch with such an
input raises (``_grad.refuse_grad``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _grad
from repro_torch.kernels.ref import wkv6_chunked, wkv6_ref

F32 = torch.float32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_SIZES = (32, 64)
_vp, _int = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv6")
    fn = lib.wkv6
    if fn.argtypes is None:
        fn.argtypes = [_int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                       _int, _int, _int, _int, _vp]
        fn.restype = _int
    return lib


def _check_len(r, chunk: int):
    """The reference's length contract, on every device: the Pallas
    wrapper (and the model's ``wkv6_chunked``) cut T into chunks of
    ``min(chunk, T)``."""
    if r.dim() != 4:
        raise ValueError("r/k/v/w must be (B, T, H, K)")
    T = r.shape[1]
    if T < 1 or chunk < 1 or T % min(chunk, T):
        raise ValueError(f"T={T} is not a multiple of min(chunk={chunk}, T)")


def _check(r, k, v, w, u, state):
    B, T, H, K = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != r {tuple(r.shape)}")
    if u.shape != (H, K) or state.shape != (B, H, K, K):
        raise ValueError(f"u {tuple(u.shape)} must be {(H, K)}, state "
                         f"{tuple(state.shape)} must be {(B, H, K, K)}")
    if K not in _HEAD_SIZES:
        raise ValueError(f"head size {K} not in {_HEAD_SIZES}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or \
            v.dtype != r.dtype:
        raise TypeError(f"r/k/v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("w", w), ("u", u), ("state", state)):
        if t.dtype != F32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for t in (k, v, w, u, state):
        if t.device != r.device:
            raise ValueError(f"tensors on {t.device} and {r.device}")
    for t in (r, k, v, w):
        if t.stride(-1) != 1:
            raise ValueError("wkv6 needs a contiguous last dimension")
    if not (u.is_contiguous() and state.is_contiguous()):
        raise ValueError("u and state must be contiguous")
    if state.data_ptr() % 16:
        raise ValueError("wkv6 needs a 16-byte aligned state")
    if T > 1:       # the chunked kernel copies rows 16 bytes at a time
        for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
            per = 16 // t.element_size()
            if t.data_ptr() % 16 or any(
                    st % per for st, n in zip(t.stride()[:3], t.shape[:3])
                    if n > 1):
                raise ValueError(f"wkv6: rows of {name} must start 16-byte "
                                 f"aligned (strides {tuple(t.stride())})")


def wkv6(r, k, v, w, u, state, *, chunk: int = 32):
    """r/k/v/w: (B, T, H, K), r/k/v float32 or bfloat16, w float32 in
    (0, 1]; u: (H, K) float32; state: (B, H, K, K) float32.

    Returns (o (B, T, H, K) float32, final state (B, H, K, K) float32)."""
    _check_len(r, chunk)
    if r.device.type == "cpu":
        from torch._subclasses.fake_tensor import FakeTensor
        if isinstance(r, FakeTensor):
            # a trace on fake tensors (the dry run) counts the chunked
            # form, the kernel's own algorithm, as the JAX package's dry
            # run traces its model's wkv6_chunked; the sequential form
            # would trace T steps
            return wkv6_chunked(r, k, v, w, u, state,
                                chunk=min(chunk, r.shape[1]))
        return wkv6_ref(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for {r.device}")
    args = (r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _WKV6.apply(*args, min(chunk, r.shape[1]))
    return _launch(*args)


class _WKV6(torch.autograd.Function):
    """The kernel forward; the chunked plain form's gradient backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk):
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.chunk = chunk
        return _launch(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, do, ds):
        grads = _grad.plain_backward(
            wkv6_chunked, ctx.saved_tensors, ctx.needs_input_grad[:6],
            (do, ds), chunk=ctx.chunk)
        return (*grads, None)


def _launch(r, k, v, w, u, state):
    """One kernel launch on CUDA tensors; raises on grad-requiring
    inputs under grad mode (the Function's forward runs without it)."""
    _grad.refuse_grad("wkv6", r, k, v, w, u, state)
    _check(r, k, v, w, u, state)
    B, T, H, K = r.shape
    o = torch.empty((B, T, H, K), dtype=F32, device=r.device)
    s_out = torch.empty((B, H, K, K), dtype=F32, device=r.device)
    if B == 0 or H == 0:
        return o, s_out
    lib = _lib()
    strides = (ctypes.c_int64 * 12)(*(s for t in (r, k, v, w)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.wkv6(_DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(),
                      v.data_ptr(), w.data_ptr(), u.data_ptr(),
                      state.data_ptr(), o.data_ptr(), s_out.data_ptr(),
                      ctypes.addressof(strides), B, T, H, K, stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {rc}")
    wkv6.launches += 1
    return o, s_out


wkv6.launches = 0

"""Causal attention within a prefill chunk: the hand-written CUDA kernel
(csrc/causal_attention.cu) and its plain PyTorch version.

The in-chunk partial of the chunked prefill and of the paged admission: the
chunk's queries attend causally over the chunk's own keys, and the result
(out normalised, lse) is LSE-merged with the history partial
(ops/pq_chunk_attention_kernel.py). Counterpart of
million_tpu/models/chunked_prefill.py::_causal_partial, which the reference
writes in plain jnp; it is not one of the reference's Pallas kernels.

Two versions behind one entry, chosen by the input type on the card: f32
inputs take an f32 version on CUDA cores (f32 models, and the card's exact
reference), bf16 inputs a tensor-core version (wgmma) that rounds where the
plain version rounds for a 16-bit model on the card: q * scale rounded to
bf16, f32 sums, the softmax weights rounded to bf16 for the P V product, the
row sums from the f32 weights.

`causal_partial` runs the plain version for CPU tensors, launches the kernel
for CUDA tensors, and raises otherwise; it counts kernel launches in
`causal_partial.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from million_tpu_torch.ops.pq_attention_ref import NEG_INF

Q_BLOCK = 128  # query rows per block (BQ and MQ in the .cu source)
KEY_TILE = {"f32": 128, "bf16": 64}  # keys per tile (BN and NT in the .cu source)
MAX_D = 128
MMA_HEAD_DIMS = (16, 64, 128)  # head dims the tensor-core version is built for
STAGES = 4  # K/V tiles in flight in the tensor-core version
SMEM_HEAD = 128  # its mbarriers

_lib = None


def _library():
    """Build (first call) and bind csrc/causal_attention.cu."""
    global _lib
    if _lib is None:
        from million_tpu_torch.ops.cuda_build import build

        lib = build("causal_attention").lib
        lib.causal_attention.restype = ctypes.c_int
        lib.causal_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_long] * 9 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.causal_attention_smem.restype = ctypes.c_long
        lib.causal_attention_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.causal_attention_key_tile.restype = ctypes.c_int
        lib.causal_attention_key_tile.argtypes = [ctypes.c_int]
        lib.causal_attention_q_block.restype = ctypes.c_int
        if lib.causal_attention_q_block() != Q_BLOCK or any(
                lib.causal_attention_key_tile(int(pr == "bf16")) != t for pr, t in KEY_TILE.items()):
            raise RuntimeError("the tiles differ between the Python wrapper and the CUDA source")
        _lib = lib
    return _lib


def causal_smem_plan(d: int, precision: str) -> int:
    """Bytes of shared memory one block takes, the mirror of
    causal_attention_smem in csrc/causal_attention.cu. "bf16": a 128-byte
    head of mbarriers and STAGES stages of a K and a V tile (64 keys of d
    bf16 each). "f32": the query tile (d x 128), the K or V tile (128 x 128)
    and the weights (128 x 132, padded), all f32."""
    if precision == "bf16":
        return SMEM_HEAD + STAGES * 2 * KEY_TILE["bf16"] * d * 2
    return 4 * (d * Q_BLOCK + KEY_TILE["f32"] * 128 + KEY_TILE["f32"] * (Q_BLOCK + 4))


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with f32 output and accumulation, 16-bit inputs kept in
    their type on the card."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def causal_partial_plain(q, k, v, scale: float, block: int = 1024):
    """Causal attention within the chunk, returning (out, lse) for
    LSE-merging. Blockwise over the KEY axis, so the score transient is
    (nc, block) and not (nc, nc); the last block may be shorter. The products
    are plain matrix products (the reference package leaves them to XLA):
    16-bit inputs with f32 accumulation for a 16-bit model on the card, f32
    otherwise. The GQA group rides the row axis, so no KV head is repeated.
    At block = KEY_TILE[precision] it rounds the softmax weights against the
    same running maxima as the kernel.

    q (bs, nh, nc, d); k/v (bs, nh_k, nc, d) -> out (bs, nh, nc, d) f32,
    lse (bs, nh, nc) f32."""
    bs, nh, nc, d = q.shape
    nh_k = k.shape[1]
    G = nh // nh_k
    block = min(block, nc)
    mm = q.dtype if q.is_cuda and q.dtype in (torch.bfloat16, torch.float16) else torch.float32
    qf = (q.to(torch.float32) * scale).to(mm).reshape(bs * nh_k, G * nc, d)  # row = g * nc + pos
    kf = k.to(mm).reshape(bs * nh_k, nc, d)
    vf = v.to(mm).reshape(bs * nh_k, nc, d)
    qpos = torch.arange(nc, device=q.device).repeat(G)[:, None]
    m = torch.full((bs * nh_k, G * nc, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((bs * nh_k, G * nc, d), dtype=torch.float32, device=q.device)
    for b0 in range(0, nc, block):
        # one (rows, block) f32 transient, updated in place: scores, then weights
        sc = _bmm_f32(qf, kf[:, b0:b0 + block].transpose(1, 2))
        kpos = b0 + torch.arange(sc.shape[-1], device=q.device)[None, :]
        sc.masked_fill_(qpos < kpos, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = sc.sub_(m_new).exp_()
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc.mul_(alpha).add_(_bmm_f32(p.to(mm), vf[:, b0:b0 + block]))
        m = m_new
        del sc, p
    safe_l = torch.clamp(l, min=1e-30)
    out = (acc / safe_l).reshape(bs, nh, nc, d)
    return out, (m + torch.log(safe_l))[..., 0].reshape(bs, nh, nc)


def _strides(t: torch.Tensor, name: str, shape, dtype, dev, align: int):
    """(batch, head, position) element strides of a (bs, heads, nc, d) view
    whose dims are contiguous; raises on what the kernel does not take."""
    if t.dtype != dtype or t.device != dev or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want a {tuple(shape)} {dtype} tensor on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    sb, sh, sn, sd = t.stride()
    if sd != 1 or any(s % align for s in (sb, sh, sn)) or t.data_ptr() % (align * t.element_size()):
        raise ValueError(f"{name}: the kernel reads rows of contiguous dims at {align * t.element_size()}-byte "
                         f"aligned strides, got strides {t.stride()}")
    return sb, sh, sn


def _launch(q, k, v, scale: float):
    dev = q.device
    bs, nh, nc, d = q.shape
    nh_k = k.shape[1]
    if k.dim() != 4 or nh_k == 0 or nh % nh_k:
        raise ValueError(f"k {tuple(k.shape)}: want (bs, nh_k, nc, d) with nh_k dividing nh={nh}")
    if q.dtype == torch.bfloat16:
        precision = "bf16"
        if d not in MMA_HEAD_DIMS:
            raise ValueError(f"the bf16 kernel is built for d in {MMA_HEAD_DIMS}, got d={d}")
    elif q.dtype == torch.float32:
        precision = "f32"
        if d > MAX_D or d % 4:
            raise ValueError(f"the f32 kernel needs d <= {MAX_D} and d % 4 == 0, got d={d}")
    else:
        raise ValueError(f"the kernel takes bf16 or f32 inputs, got {q.dtype}")
    align = 8 if precision == "bf16" else 1  # 16-byte copies of K/V rows; q is read by element
    qs = _strides(q, "q", (bs, nh, nc, d), q.dtype, dev, 1)
    ks = _strides(k, "k", (bs, nh_k, nc, d), q.dtype, dev, align)
    vs = _strides(v, "v", (bs, nh_k, nc, d), q.dtype, dev, align)
    lib = _library()
    mma = int(precision == "bf16")
    need = lib.causal_attention_smem(d, mma)
    if need != causal_smem_plan(d, precision):
        raise RuntimeError("the shared-memory plan differs between the Python wrapper and the CUDA source")
    out = torch.empty((bs, nh, nc, d), dtype=torch.float32, device=dev)
    lse = torch.empty((bs, nh, nc), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse, False
    err = lib.causal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), *qs, *ks, *vs,
        bs, nh_k, nh // nh_k, nc, d, float(scale), mma, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"causal_attention launch failed: CUDA error {err}")
    return out, lse, True


def causal_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention within a chunk: q (bs, nh, nc, d), k/v (bs, nh_k, nc,
    d) in the model's type, read through their strides (dims contiguous) ->
    (out (bs, nh, nc, d) f32 normalised, lse (bs, nh, nc) f32). CPU tensors
    take the plain version; CUDA tensors launch the kernel (bf16: the
    tensor-core version, f32: the f32 version) or raise."""
    if q.device.type == "cpu":
        return causal_partial_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out, lse, launched = _launch(q, k, v, scale)
    if launched:
        causal_partial.launches += 1
    return out, lse


causal_partial.launches = 0


def causal_ops(bs: int, nh: int, nc: int, d: int) -> int:
    """Operations of one call: a multiply-add is 2, over d for q . k and for
    P V, per (row, key) pair on or under the diagonal, nc (nc + 1) / 2 per
    query head."""
    return 2 * bs * nh * nc * (nc + 1) * d


def causal_bytes(bs: int, nh: int, nh_k: int, nc: int, d: int, itemsize: int = 2) -> int:
    """Bytes one call must move at least: q, k and v read once in the
    model's type (itemsize bytes), out and lse written once in f32."""
    return bs * nc * d * itemsize * (nh + 2 * nh_k) + bs * nh * nc * (d + 1) * 4

"""Launch binding of the CUDA ``decode_attention`` kernel
(``csrc/decode_attention.cu``).

Replaces the TPU kernel ``decode_attention_p`` of
``src/repro/kernels/decode_attention/kernel.py``; the source note of the
``.cu`` file says what bounds it on the H100 and what its design does
about it.  Callers go through :func:`ops.decode_attention`, which
validates the tensors and counts launches.
"""

from __future__ import annotations

import torch

#: The largest G = H / Hkv and head dim D the kernel takes (G: 16 in
#: recurrentgemma-9b; D: 256, its head_dim, the largest of the repo's
#: configs).
MAX_GROUP = 16
MAX_HEAD_DIM = 256


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor, out: torch.Tensor, *, scale: float,
           fast: bool) -> None:
    """out(B, H, D) = attention of q(B, H, D) over K/V(B, S, Hkv, D) up to
    ``lengths`` (B,), on the current stream of ``q``'s device.  The
    wrapper has checked devices, dtypes, shapes and contiguity."""
    from .. import build

    lib = build.load()
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, s, hkv, h // hkv, d, float(scale),
            int(bool(fast)), stream)
    build.check(lib, rc, "decode_attention")

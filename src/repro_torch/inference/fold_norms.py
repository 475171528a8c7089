"""Load-time RMSNorm folding for the transformer zoo (paper §3.5).

The port of ``repro.inference.fold_norms``.  The paper folds batch-norm's
affine into the adjacent weights; the transformer twin moves RMSNorm's
learned diagonal scale ``diag(1+γ)`` into the *following* projection:

    proj(rms(x) * (1+γ))  ==  rms(x) @ (diag(1+γ) W)

so at load time γ' = 0 and W' = diag(1+γ)·W.  Inference only.  The
normalization itself (the rsqrt of the mean square) stays; numerics
change by float associativity only.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def _scale_rows(w: torch.Tensor, scale: torch.Tensor,
                axis: int) -> torch.Tensor:
    """w scaled by ``scale`` along ``axis`` (the fan-in dim).  2-D scales
    are (L, D) for layer-stacked weights (L on dim 0, D on ``axis``)."""
    shape = [1] * w.ndim
    shape[axis] = w.shape[axis]
    if scale.ndim == 2:
        shape[0] = w.shape[0]
    return (w.float() * scale.reshape(shape).float()).to(w.dtype)


def _fold_layer(cfg, lp: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
    """Fold ln1 into the attention input projections and ln2 into the
    FFN input projections of one (stacked) layer tree."""
    lp = dict(lp)
    folds = 0
    s1 = 1.0 + lp["ln1"].float()          # (L, D)
    s2 = 1.0 + lp["ln2"].float()

    attn = dict(lp["attn"])
    for k in (("q_down", "kv_down") if cfg.mla else ("wq", "wk", "wv")):
        attn[k] = _scale_rows(attn[k], s1, 1)
        folds += 1
    lp["attn"] = attn
    lp["ln1"] = torch.zeros_like(lp["ln1"])

    ffn = dict(lp["ffn"])
    if cfg.n_experts:
        ffn["router"] = _scale_rows(ffn["router"], s2, 1)
        ffn["wi_gate"] = _scale_rows(ffn["wi_gate"], s2, 2)
        ffn["wi_up"] = _scale_rows(ffn["wi_up"], s2, 2)
        folds += 3
        if cfg.n_shared:
            sh = dict(ffn["shared"])
            sh["wi_gate"] = _scale_rows(sh["wi_gate"], s2, 1)
            sh["wi_up"] = _scale_rows(sh["wi_up"], s2, 1)
            ffn["shared"] = sh
            folds += 2
    else:
        ffn["wi_gate"] = _scale_rows(ffn["wi_gate"], s2, 1)
        ffn["wi_up"] = _scale_rows(ffn["wi_up"], s2, 1)
        folds += 2
    lp["ffn"] = ffn
    lp["ln2"] = torch.zeros_like(lp["ln2"])
    return lp, folds


def fold_norms(cfg, params: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict]:
    """Inference-time norm fold for transformer-family params.  Returns
    (new_params, report); the params passed in are left as they are.
    A no-op for the other families, as in the reference."""
    if cfg.family not in ("dense", "moe", "vlm"):
        return params, {"folds": 0, "note": f"family {cfg.family}: skipped"}
    params = dict(params)
    layers, folds = _fold_layer(cfg, params["layers"])
    params["layers"] = layers
    # Final norm -> unembedding (untied heads only: with tied embeddings
    # the matrix is shared with the input lookup, which must stay raw).
    if not cfg.tie_embeddings and "head" in params:
        sf = 1.0 + params["ln_f"].float()
        params["head"] = _scale_rows(params["head"], sf, 0)
        params["ln_f"] = torch.zeros_like(params["ln_f"])
        folds += 1
    return params, {"folds": folds}

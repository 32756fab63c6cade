"""Parameter bridge: a numpy params tree -> the port's tensors.

The port keeps the JAX params tree exactly (``embed``, ``final_norm``,
``layers/{ln1, ln2, attn/{wq, wk, wv, wo, bq, bk, bv}, mlp/{w_gate,
w_up, w_down}}``, stacked ``[L, ...]``; RWKV6's ``lm_head`` and
``layers/{ln1_s, ln1_b, ln2_s, ln2_b, mu_x, mu, lora_A, lora_B, wr, wk,
wv, wg, wo, w0, wdecay_A, wdecay_B, u, gn_s, gn_b, mu_ck, mu_cr, wck,
wcv, wcr}``; MoE layers' ``moe/{router, w_gate, w_up, w_down,
shared/{w_gate, w_up, w_down}}`` in place of ``mlp``; the hybrid model's
``supers`` and ``tail``; the encoder-decoder's ``encoder``, ``decoder``
(with ``ln_x`` and ``xattn/{wq, wk, wv, wo}``) and ``enc_norm``), so the map is
the identity on names: ``np.asarray`` each
leaf of a JAX params tree (or take the arrays ``checkpoint/format.py``'s
``flatten_tree`` yields, nested back by their ``/`` paths) and hand the
tree here.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

#: leaves the JAX init keeps in float32 whatever the model dtype: the
#: RG-LRU's Lambda (``models/rglru.py``), from which the decay
#: ``a = exp(-8 softplus(Lambda) r)`` is computed in float32, and the MoE
#: router (``models/moe.py``), whose logits are computed in float32, so a
#: rounded router would move expert choices.  RWKV6's
#: ``w0`` and ``u`` are not among them: JAX keeps them in the model dtype
#: and casts them to float32 where the decay and the bonus are computed.
FLOAT32_LEAVES = frozenset({"lam", "router"})


def params_from_numpy(tree: Mapping[str, Any], *, device,
                      dtype: torch.dtype) -> Dict[str, Any]:
    """Same names, same shapes; every leaf becomes a tensor on ``device``
    of the model ``dtype``, except the leaves named in
    :data:`FLOAT32_LEAVES`, which stay float32.  Leaves may be numpy
    arrays or anything ``np.asarray`` takes (a bfloat16 leaf goes through
    float32, which is exact)."""
    out: Dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[name] = params_from_numpy(leaf, device=device, dtype=dtype)
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(
            device=device,
            dtype=torch.float32 if name in FLOAT32_LEAVES else dtype)
    return out

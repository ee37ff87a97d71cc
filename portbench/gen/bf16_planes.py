"""The byte planes of one decoder layer's bf16 weights, as a checkpoint
saved by byte planes holds them (ZipNN, arXiv:2411.05239, groups a bf16
tensor's bytes by position; DFloat11, arXiv:2504.11651, decodes weights on
the GPU).

The tensors are those of one mixture-of-experts decoder layer of a
DeepSeek-V2 configuration (``modeling_deepseek.py``): latent attention
(``q_proj`` when ``q_lora_rank`` is null, else ``q_a_proj``,
``q_a_layernorm`` and ``q_b_proj``; ``kv_a_proj_with_mqa``,
``kv_a_layernorm``, ``kv_b_proj``, ``o_proj``), the two layer norms, the
router ``mlp.gate``, ``n_routed_experts`` experts of three matrices and the
shared experts' three matrices, ``n_shared_experts`` experts wide.

The widths are the configuration's own keys; the parameters are its
``data``: ``std`` and ``norm_mean``.  Weights are drawn on ``device`` in
one call from a generator seeded from the seed: N(0, ``std``) for matrices
and ``norm_mean`` + N(0, ``std``) for norms, in bf16.  Each tensor gives
two planes, uint8 tensors on ``device``: ``.hi`` (sign and exponent, the
high byte) and ``.lo``.  ``tiny`` cuts a configuration to the widths the
CPU tests code in a moment.
"""

from __future__ import annotations

import copy

import torch

#: The widths of a layer small enough for the plain versions on the CPU.
TINY_LAYER = dict(hidden_size=64, num_attention_heads=2, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
                  n_routed_experts=2, moe_intermediate_size=48,
                  n_shared_experts=2)


def layer_tensors(c: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every weight of one MoE decoder layer."""
    h, nh = c["hidden_size"], c["num_attention_heads"]
    nope, rope, v = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                     c["v_head_dim"])
    kv = c["kv_lora_rank"]
    t = []
    if c["q_lora_rank"] is None:
        t.append(("self_attn.q_proj", (nh * (nope + rope), h)))
    else:
        q = c["q_lora_rank"]
        t += [("self_attn.q_a_proj", (q, h)), ("self_attn.q_a_layernorm",
                                                (q,)),
              ("self_attn.q_b_proj", (nh * (nope + rope), q))]
    t += [("self_attn.kv_a_proj_with_mqa", (kv + rope, h)),
          ("self_attn.kv_a_layernorm", (kv,)),
          ("self_attn.kv_b_proj", (nh * (nope + v), kv)),
          ("self_attn.o_proj", (h, nh * v)),
          ("input_layernorm", (h,)),
          ("post_attention_layernorm", (h,)),
          ("mlp.gate", (c["n_routed_experts"], h))]
    m = c["moe_intermediate_size"]
    for e in range(c["n_routed_experts"]):
        t += [(f"mlp.experts.{e}.gate_proj", (m, h)),
              (f"mlp.experts.{e}.up_proj", (m, h)),
              (f"mlp.experts.{e}.down_proj", (h, m))]
    s = m * c["n_shared_experts"]
    t += [("mlp.shared_experts.gate_proj", (s, h)),
          ("mlp.shared_experts.up_proj", (s, h)),
          ("mlp.shared_experts.down_proj", (h, s))]
    return t


def make(config: dict, seed: int, device) -> list[tuple[str, torch.Tensor]]:
    p = config["data"]
    tensors = layer_tensors(config)
    numels = [int(torch.Size(shape).numel()) for _, shape in tensors]
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    flat = torch.empty(sum(numels), dtype=torch.bfloat16, device=device)
    flat.normal_(0.0, p["std"], generator=g)
    planes, off = [], 0
    for (name, shape), n in zip(tensors, numels):
        w = flat[off:off + n]
        off += n
        if len(shape) == 1:  # a norm's weight
            w.add_(p["norm_mean"])
        b = w.view(torch.uint8).view(n, 2)  # little-endian: lo, hi
        planes += [(f"{name}.hi", b[:, 1].contiguous()),
                   (f"{name}.lo", b[:, 0].contiguous())]
    del flat
    return planes


def tiny(config: dict) -> dict:
    """``config`` at the widths of ``TINY_LAYER``."""
    c = copy.deepcopy(config)
    c.update(TINY_LAYER)
    return c

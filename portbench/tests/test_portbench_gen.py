"""The generators: deterministic from the seed, and the checkpoint layer's
tensors as the published configuration gives them."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.gen import bf16_planes, text_zipf

from ._cells import ROOT, tiny

BIG_SEED = 2**31 + 977  # beyond 32 signed bits, as the benchmark's seeds


def test_text_is_deterministic_from_the_seed():
    cfg = tiny("text-zipf82-1e8.compress").config
    a = text_zipf.make(cfg, BIG_SEED, "cpu")
    b = text_zipf.make(cfg, BIG_SEED, "cpu")
    c = text_zipf.make(cfg, BIG_SEED + 1, "cpu")
    assert [x for _, x in a] == [x for _, x in b]
    assert [x for _, x in a] != [x for _, x in c]
    assert len({x for _, x in a}) == len(a) == cfg["data"]["buffers"]
    d = cfg["data"]
    for _, buf in a:
        v = np.frombuffer(buf, np.uint8)
        assert v.size == d["bytes"]
        assert v.min() >= d["alphabet_first"]
        assert v.max() < d["alphabet_first"] + d["alphabet_size"]


def test_text_law_is_zipf_over_82_symbols():
    cfg = tiny("text-zipf82-1e8.compress").config
    cfg["data"].update(buffers=1, bytes=400_000)
    (_, buf), = text_zipf.make(cfg, 5, "cpu")
    counts = np.bincount(np.frombuffer(buf, np.uint8), minlength=256)
    p = counts[counts > 0] / counts.sum()
    bits = -(p * np.log2(p)).sum()
    assert np.count_nonzero(counts) == 82
    assert 4.7 < bits < 4.9  # order-0 entropy of Zipf(1.1) over 82
    assert counts[32] > counts[33] > counts[40] > counts[100]


def test_layer_shapes_and_totals_match_the_published_config():
    cfg = harness.load_cell(harness.HERE.parent,
                            "ckpt-dsv2lite-layer.load").config
    t = dict(bf16_planes.layer_tensors(cfg))
    assert len(t) == 203
    assert sum(int(np.prod(s)) for s in t.values()) == 584_847_872
    assert t["self_attn.q_proj"] == (3072, 2048)
    assert t["self_attn.kv_a_proj_with_mqa"] == (576, 2048)
    assert t["self_attn.kv_a_layernorm"] == (512,)
    assert t["self_attn.kv_b_proj"] == (4096, 512)
    assert t["self_attn.o_proj"] == (2048, 2048)
    assert t["mlp.gate"] == (64, 2048)
    assert t["mlp.experts.63.down_proj"] == (2048, 1408)
    assert t["mlp.shared_experts.up_proj"] == (2816, 2048)
    sizes = [int(np.prod(s)) for s in t.values()]
    assert min(sizes) == 512 and max(sizes) == 6_291_456


def test_q_lora_layers_get_their_low_rank_pair():
    cfg = dict(bf16_planes.TINY_LAYER, q_lora_rank=24)
    names = dict(bf16_planes.layer_tensors(cfg))
    assert names["self_attn.q_a_proj"] == (24, 64)
    assert names["self_attn.q_b_proj"] == (2 * 24, 24)
    assert "self_attn.q_proj" not in names


@pytest.mark.parametrize("seed", [0, BIG_SEED])
def test_planes_are_deterministic_and_split_bf16(seed):
    cfg = tiny("ckpt-dsv2lite-layer.save").config
    a = bf16_planes.make(cfg, seed, "cpu")
    b = bf16_planes.make(cfg, seed, "cpu")
    assert [n for n, _ in a] == [n for n, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert len(a) == 2 * len(bf16_planes.layer_tensors(cfg))
    planes = dict(a)
    hi, lo = planes["input_layernorm.hi"], planes["input_layernorm.lo"]
    w = ((hi.to(torch.int32) << 8) | lo.to(torch.int32)).to(torch.int16)
    norm = w.view(torch.bfloat16).float()
    assert abs(norm.mean().item() - 1.0) < 0.02
    hi_m = planes["self_attn.o_proj.hi"]
    assert hi_m.dtype == torch.uint8 and hi_m.is_contiguous()


# the cuts the CPU tests have always used
TEXT_CUT = dict(buffers=3, bytes=40000)
LAYER_CUT = dict(hidden_size=64, num_attention_heads=2, qk_nope_head_dim=16,
                 qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
                 n_routed_experts=2, moe_intermediate_size=48,
                 n_shared_experts=2)


@pytest.mark.parametrize("workload,gen,cut", [
    ("text-zipf82-1e8.compress", text_zipf,
     lambda c: dict(c, data=dict(c["data"], **TEXT_CUT))),
    ("ckpt-dsv2lite-layer.save", bf16_planes, lambda c: dict(c, **LAYER_CUT))])
def test_each_generator_cuts_its_own_configuration(workload, gen, cut):
    """``tiny`` of each generator gives that cut, leaves the configuration
    it is given as it was, and is the cut the tests' cells take."""
    config = harness.load_cell(ROOT, workload).config
    before = repr(config)
    assert gen.tiny(config) == cut(config)
    assert repr(config) == before
    assert tiny(workload).config == cut(config)

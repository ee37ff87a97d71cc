"""Cells of BENCHMARK.json cut to sizes the plain PyTorch versions code in
a moment on the CPU: the same files, mixes and metrics, tiny inputs."""

import copy

from portbench import harness

ROOT = harness.HERE.parent
CELLS = ("text-zipf82-1e8.decompress", "ckpt-dsv2lite-layer.load",
         "text-zipf82-1e8.compress", "ckpt-dsv2lite-layer.save")
TINY_LAYER = dict(hidden_size=64, num_attention_heads=2, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
                  n_routed_experts=2, moe_intermediate_size=48,
                  n_shared_experts=2)


def tiny(workload: str) -> harness.Cell:
    cell = harness.load_cell(ROOT, workload)
    c = copy.deepcopy(cell.config)
    if c["data"]["generator"] == "text_zipf":
        c["data"].update(buffers=3, bytes=40000)
    else:
        c.update(TINY_LAYER)
    cell.config = c
    return cell

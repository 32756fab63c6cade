"""A throwaway checkout for the CPU tests: a copy of ``perfbench/`` beside
a link to ``src/``, with a tiny configuration, tiny mixes and cells of
their own added as new files only."""
import json
import os
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SRC = HERE.parent / "src"

DENSE = {"num_hidden_layers": 2, "hidden_size": 64,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "intermediate_size": 128, "vocab_size": 512}
MOE = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
       "num_key_value_heads": 4, "vocab_size": 512, "num_experts": 8,
       "num_experts_per_tok": 2, "moe_intermediate_size": 32,
       "shared_expert_intermediate_size": 64}


def _conf(name: str, sizes: dict, dtype: str) -> dict:
    c = json.loads((HERE / "configs" / f"{name}.json").read_text())
    c.update(sizes, torch_dtype=dtype)
    return c


def make(root: Path, dtype: str = "float32", limit: float = 1e-3) -> Path:
    """``root`` holding BENCHMARK.json, perfbench/ and src/; cells
    ``tiny.chat`` and ``tiny.heavy``."""
    shutil.copytree(HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(SRC, root / "src")
    pb = root / "perfbench"
    (pb / "configs" / "tiny-dense.json").write_text(
        json.dumps(_conf("qwen2-1.5b", DENSE, dtype)))
    (pb / "configs" / "tiny-moe.json").write_text(
        json.dumps(_conf("qwen2-moe-a2.7b", MOE, dtype)))
    chat = json.loads((pb / "traffic" / "chat-sessions.json").read_text())
    chat["server"].update(max_batch=8, cache_len=512, prefill_chunk=16,
                          max_step_tokens=64)
    chat.update(system_prompts={"length": 32,
                                "weights": [0.55, 0.25, 0.15, 0.05]},
                user_tokens={"median": 12, "sigma": 0.5, "min": 4, "max": 64},
                reply_tokens={"median": 8, "sigma": 0.4, "min": 4,
                              "max": 16},
                prompt_grid=16, context_cap=512, session_rate_per_s=1.0,
                think_s_mean=0.2, trace_delay_s=0.2, trace_s=0.5,
                drain_s=30, sample_requests=4, preroll_s=1.0)
    chat["warmup"].update(reply=4)
    (pb / "traffic" / "tiny-chat.json").write_text(json.dumps(chat))
    heavy = json.loads((pb / "traffic" / "decode-heavy.json").read_text())
    heavy["server"].update(max_batch=8, cache_len=256, prefill_chunk=16)
    heavy.update(clients=6, prompt_tokens={"min": 20, "max": 60},
                 output_tokens={"median": 10, "sigma": 0.3, "min": 6,
                                "max": 16},
                 trace_delay_s=0.2, trace_s=0.5, sample_requests=3)
    heavy["warmup"] = {"seconds": 1.0}
    (pb / "traffic" / "tiny-heavy.json").write_text(json.dumps(heavy))
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["configs"] += [
        {"name": "tiny-dense", "source": "test",
         "file": "perfbench/configs/tiny-dense.json", "reduced": [],
         "why": "test"},
        {"name": "tiny-moe", "source": "test",
         "file": "perfbench/configs/tiny-moe.json", "reduced": [],
         "why": "test"}]
    spec["workloads"] += [
        {"name": "tiny.chat", "config": "tiny-dense", "traffic": "tiny-chat",
         "chips": 1, "why": "test"},
        {"name": "tiny.heavy", "config": "tiny-moe", "traffic": "tiny-heavy",
         "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"].endswith(".chat") or m["name"] in (
                "ttft_p95_ms", "prefix_reuse_share"):
            m.setdefault("workloads", []).append("tiny.chat")
        if m["name"].endswith(".tput") or m["name"] == "serve_tokens_per_s":
            m.setdefault("workloads", []).append("tiny.heavy")
        if m["name"] == "tpot_p95_ms":
            m["workloads"] += ["tiny.chat", "tiny.heavy"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    lim = {"failed": {"limit": 0}, "served_gap": {"limit": limit}}
    for cell in ("tiny.chat", "tiny.heavy"):
        (pb / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    return root

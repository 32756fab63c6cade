"""The roofline's counts against the same counts worked out by hand."""
import json
from pathlib import Path

import roofline as R

CONF = json.loads((Path(__file__).resolve().parents[1] / "configs" /
                   "qwen2-1.5b.json").read_text())
MOE = json.loads((Path(__file__).resolve().parents[1] / "configs" /
                  "qwen2-moe-a2.7b.json").read_text())


def test_decode_token_at_1024_keys():
    m = R.Model(CONF)
    # per layer: q, o 1536 x 1536; k, v 1536 x 256; biases 1536 + 2 * 256;
    # SwiGLU 3 x 1536 x 8960 -> 46,794,752; 28 layers -> 1,310,253,056
    assert m.matmul_params_per_token() == 1_310_253_056
    # 2 x params + attention 4 * 28 * 12 * 128 * 1024 + logits 2 * 1536 *
    # 151936
    assert m.decode_token_flops(1024) == \
        2_620_506_112 + 176_160_768 + 466_747_392
    # K and V: 2 * 28 layers * 2 heads * 128 * 2 bytes = 28,672 a position
    assert m.kv_bytes(1024) == 29_360_128
    # query and output: 2 * 12 * 128 * 2 bytes * 28 layers = 172,032
    assert m.decode_attn_bytes(1024) == 29_532_160


def test_train_step_b8_t512():
    m = R.Model(CONF)
    # 6 * (1,310,253,056 + 1536 * 151936 logits) * 512 = 4,742,021,382,144
    # a row, plus causal attention 3 * 4 * 28 * 12 * 128 * (512 * 513 / 2)
    # = 67,777,855,488; eight rows: 38.48 TFLOP
    assert m.train_step_flops(8, 512) == \
        8 * (4_742_021_382_144 + 67_777_855_488)


def test_weight_bytes():
    # 1,543,714,304 parameters in bf16: the 3.09 GB of the served model
    assert R.Model(CONF).weight_bytes() == 3_087_428_608
    # 14,315,735,040 parameters, the 24 routers [2048, 60] in float32
    assert R.Model(MOE).weight_bytes() == 28_631_470_080 + 5_898_240


def test_bound_takes_the_larger():
    assert R.bound_s(989e12, 0, "bfloat16") == 1.0
    assert R.bound_s(0, 3.35e12, "bfloat16") == 1.0
    assert R.bound_s(989e9, 3.35e12, "bfloat16") == 1.0


def test_row_steps_split_bursts():
    assert R.row_steps([0.0, 0.001, 0.002, 0.1, 0.2, 0.2001], 0.005) == \
        [0, 3, 4]

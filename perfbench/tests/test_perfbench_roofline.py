"""The yardstick's counts against hand counts at small shapes: the kernels'
(roofline.py) and the llama architecture's (reference/llama.py), and the
readers' sum of the architecture's counts over steps."""

from __future__ import annotations

import types

from perfbench import readers
from perfbench import roofline as R
from perfbench.reference import llama

TINY = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
        "num_key_value_heads": 1, "head_dim": 2, "vocab_size": 10}


def test_bound_is_the_larger_side():
    assert R.bound_s(3.35e12, 0, R.BF16_OPS_PER_S) == 1.0
    assert R.bound_s(0, 67e12, R.F32_OPS_PER_S) == 1.0
    assert R.bound_s(3.35e12, 2 * 67e12, R.F32_OPS_PER_S) == 2.0


def test_decode_row_ops_takes_the_cheaper_route():
    # direct: 2 n d a side; table: 2 C d + n M
    assert R.decode_row_ops(10, 8) == 320
    assert R.decode_row_ops(10, 8, M=4, M_v=4, C=16, C_v=16) == 320  # 296 > 160: direct
    assert R.decode_row_ops(1000, 8, M=4, M_v=4, C=16, C_v=16) == 2 * (2 * 16 * 8 + 4000)
    # exact channels: 2 a token on the key side; the value side's table skips them
    assert R.decode_row_ops(1000, 8, OK=2, OV=2, M=4, M_v=4, C=16, C_v=16) == (
        2 * 16 * 8 + 4000) + 2 * 1000 * 2 + (2 * 16 * 6 + 1000 * (4 + 4))


def test_paged_call():
    nbytes, ops = R.paged_call([10, 0], [3, 1], nh_k=2, G=2, d=8, M=4, C=16, O=0)
    codes = 10 * 2 * (2 * 4)
    resid = (3 + 1) * 2 * 2 * 8 * 2
    books = 2 * 4 * 16 * 2 * 4
    qo = 2 * 2 * 2 * (2 * 8 + 1) * 4
    assert nbytes == codes + resid + books + qo == 1984
    assert ops == 2 * 2 * ((320 + 4 * 3 * 8) + 4 * 1 * 8) == 1792


def test_paged_call_exact_channels():
    nbytes, _ = R.paged_call([4], [0], nh_k=1, G=1, d=8, M=2, C=4, O=2)
    assert nbytes == 4 * (2 * 2 + 2 * 2 * 2) + 2 * 2 * 4 * 4 * 4 + (2 * 8 + 1) * 4


def test_chunk_call():
    nbytes, ops = R.chunk_call(2, 6, 5, nh_k=1, d=4, M=2, O=1)
    assert nbytes == 2 * (6 * 9 * 4 + 5 * (2 * 2 + 2 * 2 * 1)) == 512
    assert ops == 2 * 2 * 6 * 5 * (2 * 4 + 1) == 1080


def test_model_flops():
    assert llama.matmul_params(TINY) == 2 * (4 * 4 * 2 + 2 * 2 * 4 + 3 * 4 * 8) == 288
    attn = 4 * 2 * 2 * 2
    assert llama.token_flops(TINY, 3, head=True) == 2 * (288 + 40) + attn * 3
    assert llama.token_flops(TINY, 3, head=False) == 2 * 288 + attn * 3
    # a prompt is its tokens without the head, plus the head once
    assert llama.prompt_flops(TINY, 3) == sum(llama.token_flops(TINY, p + 1, False) for p in range(3)) + 2 * 40
    # decode tokens at positions 0 and 2 attend 1 and 3 keys, with the head
    ns = types.SimpleNamespace
    step = ns(calls=ns(ticks=[ns(positions=[0, 2])], admissions=[ns(lens=[3])]))
    assert readers.step_flops(llama, TINY, [step]) == (
        llama.token_flops(TINY, 1, True) + llama.token_flops(TINY, 3, True) + llama.prompt_flops(TINY, 3))

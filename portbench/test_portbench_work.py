"""The yardstick's counts against values worked by hand at small shapes,
the readers on a made-up reading, and the trace helpers on made-up
events."""

from __future__ import annotations

import pytest

from portbench import harness, trace, work


def test_flash_counts():
    # b 1, s 4, h 2, kh 1, d 8: 10 causal pairs, 4 flop a pair a dim
    assert work.flash(1, 4, 2, 1, 8) == (4 * 2 * 8 * 10,
                                          2 * (2 * 4 * 2 * 8 + 2 * 4 * 8))
    # a window of 2 over 5 positions keeps 1 + 2 + 2 + 2 + 2 pairs
    assert work.causal_pairs(5, 2) == 9
    assert work.causal_pairs(5, 8) == 15


def test_decode_attention_counts():
    # b 2, 5 valid positions, h 4, kh 2, d 8
    assert work.decode_attention(2, 5, 4, 2, 8) == (
        4 * 2 * 4 * 8 * 5, 2 * (2 * 2 * 5 * 2 * 8 + 2 * 2 * 4 * 8) + 20)


def test_ssd_scan_counts():
    # b 1, L 6, h 2, p 4, g 1, n 3, chunk 4: in-chunk pairs 10 + 3
    flops, nbytes = work.ssd_scan(1, 6, 2, 4, 1, 3, 4)
    assert flops == 2 * (2 * 13 * (3 + 4) + 4 * 6 * 3 * 4) == 940
    assert nbytes == 2 * (2 * 6 * 2 * 4 + 2 * 6 * 3) + 4 * (6 * 2 + 2 + 2 * 4 * 3)


DENSE = {"family": "dense", "n_layers": 1, "d_model": 4, "n_heads": 2,
         "n_kv_heads": 1, "d_head": 2, "d_ff": 8, "vocab_size": 10}
MOE = dict(DENSE, family="moe", n_experts=4, top_k=2, d_expert=3)


def test_whole_step_dense():
    # a token multiplies 4*2*(2*2 + 2*1) = 48 attention and 3*4*8 = 96
    # MLP weights: 2 * 3 * 144 = 864 flop; attention over 6 causal pairs
    # 4 * 2 * 2 * 6 = 96; the logits at the last position 2 * 4 * 10 = 80
    assert work.prefill_flops(DENSE, 1, 3) == 864 + 96 + 80
    flops, nbytes = work.decode_step(DENSE, 2, 3)
    assert flops == 2 * 2 * (144 + 40) + 4 * 2 * 2 * 2 * 3
    # weights (the embedding table aside): 48 + 2 norms of 4 + 96, and the
    # head 4 x 10 and the final norm, in bf16; 2 embedding rows; the cache
    weights = 2 * (48 + 8 + 96) + 2 * (40 + 4)
    cache = 2 * (2 * 2 * 3 * 1 * 2 + 2 * 2 * 2 * 2) + 4 * 3
    assert nbytes == weights + 2 * 2 * 4 + cache


def test_whole_step_moe():
    # per token: attention 48, two experts of 3*4*3 = 36 and the router 16
    assert work.prefill_flops(MOE, 1, 3) == 2 * 3 * (48 + 72 + 16) + 96 + 80
    _, nbytes = work.decode_step(MOE, 2, 3)
    weights = 2 * (48 + 8 + 4 * 36) + 4 * 16 + 2 * (40 + 4)
    cache = 2 * (2 * 2 * 3 * 1 * 2 + 2 * 2 * 2 * 2) + 4 * 3
    assert nbytes == weights + 2 * 2 * 4 + cache


def test_bound_takes_the_larger_term():
    assert work.bound_s(work.PEAK_FLOPS, 0) == 1.0
    assert work.bound_s(0, work.PEAK_BYTES * 2) == 2.0


def _reading(**kw):
    base = dict(cfg=dict(MOE), units=[("prefill", 1, 3), ("prefill", 1, 3)],
                window_s=1e-6, kernel_s={"flash": 2e-9, "glue": 4e-6},
                busy_s=0.5e-6, top_ops=[], host_prefill_ms=[2.0, 4.0])
    base.update(kw)
    return trace.Reading(**base)


@pytest.mark.parametrize("name,expect", [
    ("flash_roofline", 100.0 * 2 * work.bound_s(*work.flash(1, 3, 2, 1, 2))
     / 2e-9),
    ("mfu.prefill", 100.0 * 2 * work.prefill_flops(MOE, 1, 3)
     / (1e-6 * work.PEAK_FLOPS)),
    ("glue_ms.prefill", 2e-3),
    ("idle_share.prefill", 50.0),
    ("ssd_scan_roofline", None),
    ("decode_attn_roofline", None),
    ("mfu.decode", None),
    ("idle_share.decode", None),
    ("host_ms.decode", None),
    ("host_ms.prefill", 3.0),
])
def test_readers_on_a_prefill_reading(name, expect):
    got = harness.metric_reader(name)(_reading())
    assert got == pytest.approx(expect) if expect is not None else got is None


def test_decode_readers():
    r = _reading(units=[("decode", 2, 3)], kernel_s={"decode_attention": 1e-9},
                 host_issue_ms=[1.0, 3.0])
    need = work.bound_s(*work.decode_step(MOE, 2, 3))
    assert harness.metric_reader("mfu.decode")(r) == pytest.approx(
        100.0 * need / 1e-6)
    assert harness.metric_reader("decode_attn_roofline")(r) == pytest.approx(
        100.0 * work.bound_s(*work.decode_attention(2, 3, 2, 1, 2)) / 1e-9)
    assert harness.metric_reader("host_ms.decode")(r) == 2.0
    assert harness.metric_reader("idle_share.decode")(r) == pytest.approx(50.0)
    assert harness.metric_reader("flash_roofline")(r) is None


@pytest.mark.parametrize("name,kind", [
    ("void flash_mma_kernel<128>(__nv_bfloat16 const*, int)", "flash"),
    ("void decode_bf16_kernel<128, false>(__nv_bfloat16 const*)",
     "decode_attention"),
    ("void ssd_mma_kernel<64>(__nv_bfloat16 const*)", "ssd_scan"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("Memcpy DtoH (Device -> Pinned)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<c10::BFloat16>>(int, ...)", "glue"),
    ("void at::native::reduce_kernel<512, 1>(...)", "glue"),
])
def test_kernel_kinds(name, kind):
    assert trace.kind_of(name) == kind


def test_union_and_gap_labels():
    ops = [("a", 0, 10), ("b", 5, 12), ("c", 20, 30), ("d", 40, 41)]
    assert trace._union(ops) == [[0, 12], [20, 30], [40, 41]]
    host = [("pb.decode_step", 0, 35, 7), ("aten::linear", 11, 16, 7),
            ("aten::mm", 12, 15, 7), ("pb.token_copy", 36, 45, 7),
            ("other thread", 0, 100, 9)]
    assert trace._gap_labels([(12, 20), (30, 40)], host) == [
        "pb.decode_step / aten::mm", "pb.decode_step"]
    assert trace._gap_labels([(37, 40)], host) == ["pb.token_copy"]

"""Port parity: ``repro_torch.roofline`` (the op walk, the H100 terms and
the report) against ``repro.roofline``.

* ``count_params`` and ``model_flops``: equal to the reference's for every
  architecture (the same Python arithmetic).
* The op walk on meta tensors: a matrix product is exactly 2·M·N·K flops
  and 4·(MK + KN + MN) bytes in float32; a Python loop of n layers counts
  n times one layer.
* The plain path (``use_kernel=False``) of the reduced qwen2.5-3b and
  mamba2-130m forwards against ``hlo_walk.analyze`` of the reference's
  jitted forward at the same configuration and batch: flops within 1e-3
  relative (equal at these sizes: both count 2·M·N·K over the same
  products, the reference's scan over layers multiplied by its trip
  count).
* Each kernel by its own formula, at two shapes, against the closed form
  computed here: flash attention 4·D·B·H over the (query, key) pairs its
  masks let through (counted from an explicit mask), decode attention
  every slot, the SSD scan's chunked products (a loop over chunks), each
  input read once and each output written once; the kernel path's flops
  are the plain path's less the masked-out score products; on meta
  outside a walk every kernel still raises.
* Functional collectives are recorded by kind (a one-process gloo group).
* The report's tables over records of walked cells: the roofline table
  and the hillclimb picks equal the reference's functions on the same
  records.
"""

import socket

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models.transformer import get_model as ref_get_model  # noqa: E402
from repro.roofline import analysis as ref_analysis  # noqa: E402
from repro.roofline import report as ref_report  # noqa: E402
from repro.roofline.hlo_walk import analyze as hlo_analyze  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import CHUNK  # noqa: E402
from repro_torch.models.transformer import get_model  # noqa: E402
from repro_torch.roofline import analysis, op_walk, report  # noqa: E402

META = torch.device("meta")


def empty(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_count_params_and_model_flops_match_reference(arch):
    cfg, ref_cfg = ARCHS[arch], REF_ARCHS[arch]
    for active in (False, True):
        assert analysis.count_params(cfg, active_only=active) == \
            ref_analysis.count_params(ref_cfg, active_only=active)
    for kind in ("train", "prefill", "decode"):
        assert analysis.model_flops(cfg, kind, 12345) == \
            ref_analysis.model_flops(ref_cfg, kind, 12345)


def test_terms_are_the_cards():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == \
        (989.4e12, 3.35e12, 450e9)
    terms = analysis.RooflineTerms(2 * 989.4e12, 3.35e12, 0.0, 1)
    ref = ref_analysis.RooflineTerms(2 * 989.4e12, 3.35e12, 0.0, 1)
    assert terms.to_dict().keys() == ref.to_dict().keys()
    assert (terms.compute_s, terms.memory_s, terms.dominant) == \
        (2.0, 1.0, "compute")
    assert terms.roofline_fraction == 1.0
    assert analysis.typed_compute_s({"bfloat16": 989.4e12,
                                     "float32": 67e12}) == 2.0


def test_matmul_flops_and_bytes():
    m, k, n = 64, 128, 48
    acc = op_walk.analyze(torch.mm, empty(m, k), empty(k, n))
    assert acc.flops == 2 * m * n * k
    assert acc.hbm_bytes == 4 * (m * k + k * n + m * n)
    assert acc.n_ops == 1 and acc.flops_by_dtype == {"float32": 2 * m * n * k}
    assert acc.to_dict()["collective_wire_bytes"] == 0.0


@pytest.mark.parametrize("n_layers", [1, 3, 8])
def test_python_layer_loop_scales_by_n(n_layers):
    w = empty(32, 32)

    def layers(h):
        for _ in range(n_layers):
            h = torch.relu(h @ w)
        return h

    one = op_walk.analyze(lambda h: torch.relu(h @ w), empty(16, 32))
    acc = op_walk.analyze(layers, empty(16, 32))
    assert acc.flops == n_layers * one.flops == n_layers * 2 * 16 * 32 * 32
    assert acc.hbm_bytes == n_layers * one.hbm_bytes
    assert acc.n_ops == n_layers * one.n_ops == 2 * n_layers


def test_views_and_allocations_move_no_bytes():
    x = empty(8, 16)
    acc = op_walk.analyze(lambda: (x.t(), x.view(16, 8), x[2:],
                                   torch.empty_like(x)))
    assert (acc.flops, acc.hbm_bytes, acc.n_ops) == (0, 0, 0)


@pytest.mark.parametrize("shape", [(2, 64), (4, 256)])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_plain_forward_flops_match_hlo_walk(arch, shape):
    batch, seq = shape
    ref = ref_get_model(REF_ARCHS[arch].reduced())
    params = jax.eval_shape(lambda: ref.init_params(jax.random.PRNGKey(0),
                                                    jnp.float32))
    text = jax.jit(lambda p, t: ref.forward(p, t)).lower(
        params, jax.ShapeDtypeStruct(shape, jnp.int32)).compile().as_text()
    want = hlo_analyze(text).flops
    api = get_model(ARCHS[arch].reduced())
    got = op_walk.analyze(api.forward,
                          api.init_params(torch.Generator(), torch.float32,
                                          META),
                          empty(batch, seq, dtype=torch.int32),
                          use_kernel=False).flops
    assert got == pytest.approx(want, rel=1e-3)


def _pairs(s, t, causal, window) -> int:
    q, k = torch.arange(s)[:, None], torch.arange(t)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool)
    if causal:
        mask &= k <= q
    if window > 0:
        mask &= (q - k) < window
    return int(mask.sum())


def _kernel(fn, name: str, *args, **kwargs) -> dict:
    acc = op_walk.analyze(fn, *args, **kwargs)
    rec = acc.kernels[name]
    assert rec["calls"] == 1 and acc.n_ops == 1
    assert (acc.flops, acc.hbm_bytes) == (rec["flops"], rec["bytes"])
    return rec


@pytest.mark.parametrize("case", [
    (4, 2000, 2000, 16, 2, 128, True, 0, torch.bfloat16),
    (2, 400, 1500, 6, 6, 64, False, 0, torch.bfloat16),
    (1, 333, 333, 4, 1, 80, True, 100, torch.float32)])
def test_flash_formula(case):
    b, s, t, h, kh, d, causal, window, dtype = case
    q, k = empty(b, s, h, d, dtype=dtype), empty(b, t, kh, d, dtype=dtype)
    rec = _kernel(ops.flash_attention, "flash_attention", q, k, k,
                  causal=causal, window=window)
    elt = q.element_size()
    assert rec["flops"] == 4 * d * b * h * _pairs(s, t, causal, window)
    assert rec["bytes"] == elt * (2 * b * s * h * d + 2 * b * t * kh * d)
    if causal and not window and s == t:
        assert rec["flops"] == 2 * d * b * h * s * (s + 1)


@pytest.mark.parametrize("case", [(4, 2048, 2, 8, 128, torch.bfloat16),
                                  (3, 127, 1, 1, 80, torch.float32)])
def test_decode_formula(case):
    b, t, kh, g, d, dtype = case
    q, k = empty(b, 1, kh * g, d, dtype=dtype), empty(b, t, kh, d, dtype=dtype)
    pos = empty(t, dtype=torch.int32)
    rec = _kernel(ops.decode_attention, "decode_attention", q, k, k, pos)
    elt = q.element_size()
    assert rec["flops"] == 4 * d * b * kh * g * t
    assert rec["bytes"] == elt * (2 * b * kh * g * d + 2 * b * t * kh * d) \
        + 4 * t


@pytest.mark.parametrize("case", [(4, 2048, 24, 64, 1, 128, torch.bfloat16),
                                  (2, 2000, 8, 32, 2, 16, torch.float32)])
def test_ssd_formula(case):
    b, l, h, p, g, n, dtype = case
    x, bc = empty(b, l, h, p, dtype=dtype), empty(b, l, g, n, dtype=dtype)
    dt, a_log = empty(b, l, h), empty(h)
    rec = _kernel(ops.ssd_scan, "ssd_scan", x, dt, a_log, bc, bc)
    flops = 0
    for t0 in range(0, l, CHUNK):
        q = min(CHUNK, l - t0)
        pairs = q * (q + 1) // 2
        flops += b * g * 2 * pairs * n + b * h * (2 * pairs * p
                                                  + 4 * q * n * p)
    elt = x.element_size()
    assert rec["flops"] == flops
    assert rec["bytes"] == elt * (2 * b * l * h * p + 2 * b * l * g * n) \
        + 4 * (b * l * h + h + b * h * p * n)


@pytest.mark.parametrize("stacked", [False, True])
def test_embedding_bag_formula(stacked):
    n_bags, bag, v, d = 32, 8, 1000, 64
    if stacked:
        idx, tables = empty(n_bags, 8, bag, dtype=torch.int32), empty(8, v, d)
        weights, out_w = None, 8 * d
    else:
        idx, tables = empty(n_bags, bag, dtype=torch.int32), empty(v, d)
        weights, out_w = empty(n_bags, bag), d
    rec = _kernel(ops.embedding_bag, "embedding_bag", idx, tables, weights)
    assert rec["flops"] == 0
    assert rec["bytes"] == 4 * (idx.numel() * (1 + d) + n_bags * out_w
                                + (0 if weights is None else idx.numel()))


@pytest.mark.parametrize("want", [(False, False, False), (True, True, True)])
def test_fcfs_formulas(want):
    n_w, nq, n_l, n_s, n_t = 3, 100, 4, 8, 2
    lat, start, slot = want
    arr, svc = empty(n_w, nq), empty(n_w, n_t, nq)
    tos, pri, free0 = empty(n_l, n_s, dtype=torch.int32), empty(n_s), \
        empty(n_l, n_s)
    rec = _kernel(ops.fcfs_scan, "fcfs_scan", arr, svc, tos, pri, free0,
                  0.02, want_lat=lat, want_start=start, want_slot=slot)
    ins = 4 * (n_w * nq + n_w * n_t * nq + 2 * n_l * n_s + n_s)
    outs = 4 * (n_w * n_l + n_w * n_l * n_s + n_w * n_l * nq * sum(want))
    assert (rec["flops"], rec["bytes"]) == (0, ins + outs)
    batches, lut = empty(n_w, nq, dtype=torch.int32), empty(5, n_t)
    free, count = empty(n_w, n_l, n_s), empty(n_w, n_l, dtype=torch.int32)
    rec = _kernel(ops.fcfs_stream, "fcfs_stream", arr, batches, lut, tos,
                  pri, free, count, 0.0, 0.02)
    carries = 4 * (n_w * n_l * n_s + n_w * n_l)
    # the carries are read and written in place
    assert rec["bytes"] == 4 * (2 * n_w * nq + 5 * n_t + n_l * n_s + n_s) \
        + 2 * carries


def test_kernels_on_meta_raise_outside_a_walk():
    q = empty(1, 8, 2, 16)
    calls = [lambda: ops.flash_attention(q, q, q),
             lambda: ops.decode_attention(q[:, :1], q, q,
                                          empty(8, dtype=torch.int32)),
             lambda: ops.ssd_scan(q, empty(1, 8, 2), empty(2), q, q),
             lambda: ops.embedding_bag(empty(4, 2, dtype=torch.int32),
                                       empty(10, 16)),
             lambda: ops.fcfs_scan(empty(1, 4), empty(1, 1, 4),
                                   empty(1, 2, dtype=torch.int32), empty(2),
                                   empty(1, 2), 0.02)]
    for call in calls:
        with pytest.raises(ValueError, match="not meta"):
            call()


def test_kernel_path_counts_the_formula_not_the_scores():
    """qwen2.5-3b reduced, causal: the plain path computes every S x S
    score and its product with v (masked after), the kernel only the
    S(S+1)/2 pairs its mask lets through."""
    cfg = ARCHS["qwen2.5-3b"].reduced()
    api = get_model(cfg)
    params = api.init_params(torch.Generator(), torch.float32, META)
    b, s = 2, 64
    tokens = empty(b, s, dtype=torch.int32)
    kernel = op_walk.analyze(api.forward, params, tokens)
    plain = op_walk.analyze(api.forward, params, tokens, use_kernel=False)
    per_pair = 4 * cfg.d_head * b * cfg.n_heads
    assert kernel.kernels["flash_attention"] == {
        "calls": cfg.n_layers, "flops": cfg.n_layers * per_pair * s * (s + 1)
        // 2, "bytes": cfg.n_layers * 4 * b * s * cfg.d_head
        * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)}
    assert plain.flops - kernel.flops == \
        cfg.n_layers * per_pair * (s * s - s * (s + 1) // 2)
    assert kernel.hbm_bytes < plain.hbm_bytes


def test_collectives_recorded_by_kind():
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        x = torch.ones(16, 4)

        def step(x):
            reduced = funcol.all_reduce(x, "sum", dist.group.WORLD)
            return funcol.wait_tensor(reduced)

        acc = op_walk.analyze(step, x)
    finally:
        dist.destroy_process_group()
    nbytes = x.numel() * 4
    assert analysis.collective_bytes(acc) == {
        **dict.fromkeys(analysis.COLLECTIVE_OPS, 0.0), "all-reduce": nbytes}
    assert acc.collective_counts["all-reduce"] == 1
    assert acc.collective_wire_bytes == 2 * nbytes


def test_report_tables_over_walked_cells(capsys):
    recs = [report.walk_cell("whisper-tiny", "decode_32k"),
            report.walk_cell("mamba2-130m", "long_500k"),
            report.walk_cell("qwen2.5-3b", "long_500k")]
    walked, skipped = recs[:2], recs[2]
    assert "skipped" in skipped
    for r in walked:
        assert r["chips"] == 1 and r["mesh"] == "single-card"
        assert r["collectives"] == dict.fromkeys(analysis.COLLECTIVE_OPS, 0.0)
        assert r["roofline"]["collective_s"] == 0.0
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    # whisper's step: self and cross attention through the decode kernel in
    # every decoder layer; the SSM's decode step runs no kernel
    assert walked[0]["kernels"]["decode_attention"]["calls"] == \
        2 * ARCHS["whisper-tiny"].n_layers
    assert walked[1]["kernels"] == {}
    assert report.roofline_table(recs) == ref_report.roofline_table(recs)
    assert len(report.roofline_table(recs).splitlines()) == 4
    assert report.pick_hillclimb_candidates(recs) == \
        ref_report.pick_hillclimb_candidates(walked)
    assert report.skipped_table(recs).splitlines()[2] == \
        f"| qwen2.5-3b | long_500k | {skipped['skipped']} |"
    walk_rows = report.dryrun_table(recs).splitlines()[2:]
    assert [row.split(" | ")[:2] for row in walk_rows] == \
        [["| whisper-tiny", "decode_32k"], ["| mamba2-130m", "long_500k"]]
    assert all(row.endswith("| 0/0/0/0/0 |") for row in walk_rows)
    hints = report.hints_table(recs).splitlines()[2:]
    assert len(hints) == 2 and all("| memory |" in h for h in hints)
    collective = dict(walked[0], roofline={**walked[0]["roofline"],
                                           "dominant": "collective"},
                      collectives={"all-reduce": 1.0})
    assert "NVLink" in report._fix_hint(dict(collective, kind="train"))
    report.main(["--arch", "whisper-tiny", "--shape", "decode_32k"])
    out = capsys.readouterr().out
    assert "989.4 TFLOP/s" in out and "| whisper-tiny | decode_32k |" in out

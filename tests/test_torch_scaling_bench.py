"""The port's scaling model (million_tpu_torch/benchmarks/scaling_bench.py)
against million_tpu's: with the TPU v5e constants and million_tpu's padded
merge payload (G = GROUP_PAD = 8) it gives million_tpu's
analytic_efficiency to 1e-12; its structure on the H100 constants; and the
multi-rank parity of the sharded paths (2 and 4 ranks, gloo) against one
rank."""

import dataclasses

import pytest

from million_tpu.benchmarks import scaling_bench as js
from million_tpu_torch.benchmarks import scaling_bench as ts


@pytest.mark.parametrize("shape", [dict(), dict(bs=1, N=131072, measured_tpot_ms=18.0),
                                   dict(bs=4, N=131072, measured_tpot_ms=40.0)])
@pytest.mark.parametrize("sp,dcn", [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2)])
def test_v5e_constants_reproduce_reference(shape, sp, dcn):
    j = js.DecodeShape(**shape)
    t = ts.DecodeShape(group=8, **{"measured_tpot_ms": j.measured_tpot_ms, **shape})
    want = js.analytic_efficiency(j, sp, dcn=dcn)
    got = ts.analytic_efficiency(t, sp, dcn=dcn, hw=ts.V5E)
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12 * max(1.0, abs(v)), k
    assert ts.merge_payload_bytes(t) == js.merge_payload_bytes(j)  # (out, lse) at G = 8


def test_model_structure_on_h100():
    s = ts.DecodeShape(measured_tpot_ms=20.0)
    assert ts.arena_scan_bytes(s) == 28 * 7 * 8 * 128 * 32768
    assert ts.merge_payload_bytes(s) == 7 * 8 * 3 * 129 * 4  # (bs, nh_k, G, d + 1) f32, G = 24 / 8
    r1 = ts.analytic_efficiency(s, 1)
    assert r1["step_speedup"] == 1.0 and r1["t_comm_ms"] == 0.0
    speed = [ts.analytic_efficiency(s, sp)["step_speedup"] for sp in (1, 2, 4)]
    assert speed == sorted(speed)
    eff = [ts.analytic_efficiency(s, sp)["attention_scaling_eff"] for sp in (2, 4, 8)]
    assert eff == sorted(eff, reverse=True) and all(0 < e <= 1 for e in eff)
    # a second node adds its merge over the slower link
    assert ts.analytic_efficiency(s, 4, dcn=2)["t_comm_ms"] > ts.analytic_efficiency(s, 4)["t_comm_ms"]
    assert ts.throughput_scaling_note()["per_step_comm_bytes"] == 0
    with pytest.raises(ValueError, match="measure"):
        ts.analytic_efficiency(dataclasses.replace(s, measured_tpot_ms=None), 2)
    assert "data-sheet" in ts.H100.name and ts.H100.hbm_gbps == 3350.0


def test_multi_rank_parity():
    gaps = ts.mesh_parity("cpu")
    assert set(gaps) == {"sp2_max_logit_diff", "sp4_max_logit_diff", "paged_tick_sp2tp2_max_logit_diff"}
    assert all(v < 1e-4 for v in gaps.values()), gaps

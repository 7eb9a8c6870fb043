"""The port's multi-rank dry run (million_tpu_torch/dryrun.py), the twin of
__graft_entry__.dryrun_multichip, on 8 CPU ranks (dcn 2 x tp 2 x sp 2):
prefill and decode on the mesh, prefill_sp and a ShardedScheduler with a
chunked admission, ticks and a flush."""

from million_tpu_torch import dryrun


def test_factor_matches_reference():
    # __graft_entry__.dryrun_multichip's factoring (dcn when 8 divides n, then sp, then tp)
    want = {1: (1, 1, 1, 1), 2: (1, 1, 1, 2), 3: (1, 3, 1, 1), 4: (1, 1, 2, 2), 6: (1, 3, 1, 2),
            8: (2, 1, 2, 2), 16: (2, 1, 4, 2), 24: (2, 3, 2, 2)}
    for n, f in want.items():
        assert dryrun.factor(n) == f, n


def test_dryrun_on_eight_ranks(capsys):
    res = dryrun.dryrun_multichip(8, "cpu")
    assert res["mesh"] == {"dcn": 2, "dp": 1, "tp": 2, "sp": 2}
    assert sorted(res["tokens"]) == [0, 1] and len(res["tokens"][0]) == 12
    assert set(res["routes"]) == {"all_reduce", "all_gather", "send/recv", "broadcast"}
    assert "dryrun_multichip OK" in capsys.readouterr().out

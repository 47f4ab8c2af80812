"""The decision rules of scripts/convergence_runs.py for the run_r5.sh gap
(PERF.md section 6): rules (a) and (b) over the default arm, the rule
naming an arm's arithmetic (Welch) over a default and an exact-float32 arm,
the iterations a second read from a cli.train log, and ``--decide``, which
pools several invocations' runs by the arm each records. Plain numbers: no
card, no net."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

import convergence_runs as cr  # noqa: E402

JAX = {"loss_means": [70.0, 53.0], "curve": {0: 24.7, 1504: 12.0, 3008: 8.5, 4512: 8.2, 6016: 8.4}}


def run(late: float, held: float = 8.4, early: float = 70.0) -> dict:
    return {"loss_means": [early, late], "epe": {1504: 11.0, 3008: held, 4512: held, 6016: held}}


def test_r5_decision_closes_only_when_jax_lies_inside_both_windows_and_2_sd():
    inside = [run(52.0, 8.0, 69.0), run(54.0, 8.8, 71.0), run(53.5, 8.4)]
    d = cr.r5_decision(inside, JAX)
    assert [w["within"] for w in d["a"]] == [True, True] and d["b"]["within"] and d["closed"]
    above = [run(54.0, 8.0, 69.0), run(56.0, 8.8, 71.0)]
    d = cr.r5_decision(above, JAX)
    assert d["a"][1]["within"] is False and not d["closed"]
    far = [run(52.0, 9.9, 69.0), run(54.0, 10.0, 71.0), run(53.0, 10.1)]
    d = cr.r5_decision(far, JAX)
    assert d["b"]["within"] is False and d["b"]["z"] < -2 and not d["closed"]


@pytest.mark.parametrize("exact,named", [
    ([53.1, 53.4, 52.9, 53.2], True),  # far below the default arm, JAX inside its min-max
    ([55.0, 54.5, 55.5, 54.8], False),  # within 2 SE of the default arm
    ([50.0, 50.5, 49.8, 50.2], False),  # far below, but JAX outside its min-max
])
def test_precision_decision_needs_a_welch_gap_and_jax_inside_the_exact_arm(exact, named):
    default = [run(v) for v in (55.0, 56.0, 54.5, 55.5, 56.5)]
    p = cr.names_cause(default, [run(v) for v in exact], JAX)
    assert p["named"] is named
    d, e = [55.0, 56.0, 54.5, 55.5, 56.5], exact
    se = (sum((x - sum(d) / 5) ** 2 for x in d) / 4 / 5 + sum((x - sum(e) / 4) ** 2 for x in e) / 3 / 4) ** 0.5
    assert p["se"] == pytest.approx(se) and p["diff"] == pytest.approx(sum(d) / 5 - sum(e) / 4)


def test_train_rate_leaves_out_the_first_display_chunk():
    log = ("Training flownets ...\nIteration 96, loss = 183.0 (6.00 iter/s)\n"
           "Iteration 192, loss = 170.0 (48.00 iter/s)\nIteration 288, loss = 150.0 (32.00 iter/s)\n"
           "Optimization done, final smoothed loss 150.0\n")
    assert cr.train_rate(log) == pytest.approx(192 / (96 / 48 + 96 / 32))


def test_decide_pools_the_runs_of_several_files_by_their_tf32_flags(tmp_path, capsys):
    def invocation(name, arm, lates):
        flags = arm == "tf32"
        runs = [dict(seed=s, arm=arm, tf32=f"TF32: cudnn {flags} matmul False", loss_means=[70.0, v],
                     iter_per_s=40.0, curve=[dict(iteration=it, epe=8.0 + s / 20) for it in (0, 1504, 3008, 4512, 6016)])
                for s, v in lates]
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({"r5": {"runs": runs, "jax": dict(JAX, curve={str(k): v for k, v in
                                                                               JAX["curve"].items()})}}))
        return str(path)

    # seed 5's TF32 run drifts outside PR 19's range, so the five TF32 runs here are the arm
    paths = [invocation("a", "tf32", [(3, 55.0), (5, 60.0)]),
             invocation("b", "tf32", [(17, 54.5), (19, 55.5), (23, 56.0)]),
             invocation("c", "exact", [(3, 54.0), (5, 55.0)])]
    assert cr.main(["--decide", ",".join(paths)]) == 0
    out = capsys.readouterr().out
    assert "TF32 drift check, seed 5: losses 3104-6016 60.0000, PR 19's ten seeds 54.0572-58.5489: outside" in out
    assert "rule (a), 5 tf32 seeds, losses 3104-6016: JAX 53.0000, port 54.5000-60.0000: outside" in out
    assert out.count("[decide] exact seed") == 2 and out.count("[decide] tf32 seed") == 5
    assert "seed 3: -1.0000, seed 5: -5.0000; mean -3.0000" in out
    assert out.rstrip().endswith("decision: open")

"""What a run may load, and how a run without a card ends."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.harness.cell import BENCH, ROOT
from benchmark.harness.common import forbidden_loaded

ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="")
ENV.pop("JAX_PLATFORMS", None)


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
                          "import json; print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, env=ENV, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_forbidden_names_compare_whole_top_level_names():
    assert forbidden_loaded(["flownet2_tpu_torch", "flownet2_tpu_torch.inference", "jaxtyping", "numpy"]) == []
    assert forbidden_loaded(["flownet2_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "flownet2_tpu", "jax", "jaxlib"]


def test_harness_drivers_and_port_load_no_jax():
    mods = _modules_after(
        "import benchmark.run, benchmark.study\n"
        "from benchmark.harness import cell, common, data, faults, readers, trace, weights, yardstick\n"
        "from benchmark.traffic import infer, train\n"
        "from benchmark.harness.cell import metric_reader, read_spec\n"
        "[metric_reader(m['name']) for m in read_spec()['per_layer']]\n"
        "import flownet2_tpu_torch.inference, flownet2_tpu_torch.train, flownet2_tpu_torch.data\n"
        "import flownet2_tpu_torch.cli.convert_dataset")
    assert forbidden_loaded(mods) == []
    assert "flownet2_tpu_torch.inference" in mods


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("import benchmark.reference.nets, benchmark.reference.train")
    assert forbidden_loaded(mods) == []
    assert not [m for m in mods if m.split(".")[0] == "flownet2_tpu_torch"]


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flownet2.chairs-b16", "--seed",
                          "2147483700", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, env=ENV,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_checkout_of_the_benchmark_alone_cannot_run(tmp_path):
    """Only BENCHMARK.json and benchmark/: the program is missing, so the
    driver's run fails, here past the look for a card."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1])\n"
            "from benchmark.harness.cell import driver, load_cell\n"
            "c = load_cell('flownet2.chairs-b16')\n"
            "driver(c).run(c, 1, 1.0, False, torch.device('cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, env=ENV,
                         cwd=tmp_path)
    assert out.returncode != 0 and "flownet2_tpu_torch" in out.stderr

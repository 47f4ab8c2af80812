"""FlowNet2's merged Caffe weights in the port, against the JAX package, on the CPU.

One set of the port's seeded FlowNet2 weights, written as a merged
``.caffemodel`` (the port's exporter, whose bytes equal the JAX exporter's:
tests/test_torch_formats.py::test_export_bytes_equal_jax), a merged
``.caffemodel.h5`` (the JAX exporter) and an ``.npz``: the port's import
equals the JAX importer's, ``run_flownet`` writes the same ``.flo`` from all
three, and the port's FlowNet2 on the imported weights agrees with the JAX
package's on the JAX importer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flownet2_tpu.cli.run_flownet import load_weights as jax_load_weights
from flownet2_tpu.models import export_caffe as jax_export
from flownet2_tpu.models import flownet2_apply as jax_flownet2_apply
from flownet2_tpu.models import import_caffe as jax_import
from flownet2_tpu_torch.checkpoint import init_params, load_into, save_params
from flownet2_tpu_torch.cli.run_flownet import main as run_flownet
from flownet2_tpu_torch.core.flow_io import read_flo, write_ppm
from flownet2_tpu_torch.models import NETS, export_caffe, flownet2_apply, import_caffe
from test_torch_formats import assert_trees_equal, nested

torch.set_num_threads(2)  # the suite runs several workers side by side


@pytest.fixture(scope="module")
def flownet2_files(tmp_path_factory):
    """The seeded FlowNet2 weights and their three files."""
    root = tmp_path_factory.mktemp("flownet2")
    params = init_params("flownet2", seed=9)
    files = {"caffemodel": str(root / "FlowNet2.caffemodel"), "h5": str(root / "FlowNet2.caffemodel.h5"),
             "npz": str(root / "FlowNet2.npz")}
    export_caffe.export_caffemodel_merged(nested(params), files["caffemodel"])
    jax_export.export_caffemodel_merged_h5(nested(params), files["h5"])
    save_params(files["npz"], params)
    return params, files


@pytest.mark.parametrize("form", ["caffemodel", "h5"])
def test_merged_flownet2_import_matches_jax(flownet2_files, form):
    """The merged FlowNet2 cascade (subnet name prefixes, per-subnet BGR
    slots), as a binaryproto and as a .caffemodel.h5: the port's import
    equals the JAX importer's and the weights that were exported."""
    params, files = flownet2_files
    ours = import_caffe.import_caffemodel(files[form], "flownet2")
    assert_trees_equal(ours, jax_import.import_caffemodel(files[form], "flownet2"))
    assert_trees_equal(ours, nested(params))


@pytest.fixture
def pair(tmp_path):
    rng = np.random.default_rng(12)
    paths = []
    for i in range(2):
        p = tmp_path / f"img{i}.ppm"
        write_ppm(p, rng.integers(0, 256, (60, 100, 3), dtype=np.uint8))
        paths.append(str(p))
    return paths


def test_run_flownet_writes_the_same_flo_from_caffemodel_h5_and_npz(tmp_path, pair, flownet2_files):
    """FlowNet2 weights as a merged .caffemodel, a merged .caffemodel.h5 and
    an .npz: the three .flo files are equal, bit for bit."""
    flows = []
    for i, form in enumerate(("caffemodel", "h5", "npz")):
        out = str(tmp_path / f"out{i}.flo")
        assert run_flownet([flownet2_files[1][form], "flownet2", *pair, out, "--device", "cpu"]) == 0
        flows.append(read_flo(out))
    assert flows[0].shape == (60, 100, 2) and np.isfinite(flows[0]).all()
    for f in flows[1:]:
        np.testing.assert_array_equal(f, flows[0])


def test_flownet2_on_imported_weights_matches_jax(flownet2_files):
    """One merged .caffemodel through each package's importer, then each
    package's FlowNet2 forward at 64x128: mean EPE <= 1e-3 px."""
    path = flownet2_files[1]["caffemodel"]
    rng = np.random.default_rng(10)
    i0 = rng.uniform(0, 255, (1, 64, 128, 3)).astype(np.float32)
    i1 = np.roll(i0, 2, axis=2)
    theirs = np.asarray(jax.jit(jax_flownet2_apply)(jax_load_weights(path, "flownet2"), jnp.asarray(i0),
                                                    jnp.asarray(i1)))
    with torch.device("meta"):
        net = NETS["flownet2"]()
    net = load_into(net, import_caffe.import_caffemodel(path, "flownet2")).eval()
    with torch.no_grad():
        ours = flownet2_apply(net, torch.from_numpy(i0), torch.from_numpy(i1)).numpy()
    assert ours.shape == theirs.shape == (1, 64, 128, 2)
    assert float(np.sqrt(((ours - theirs) ** 2).sum(-1)).mean()) <= 1e-3

"""The controls of the comparisons that decide ``correct``: the plain
reference put in the program's place and computed in the precision below
the configuration's (convolutions on bfloat16 operands) has to come out
not correct. Here at a size a test run holds, on the CPU, where the
program itself computes exact float32 and reads about 0; on the card
(``-m gpu``), at each cell's own size, where the program runs TF32."""

import pytest
import torch

from benchmark.harness.cell import load_cell, unlisted_cell
from benchmark.traffic import infer, train

CPU = torch.device("cpu")
SEEDS = (1, 2, 3)
INFER = ("flownet2.sintel-b4", "flownet2.chairs-b16")
TRAIN = ("flownetc.chairs-aug-b8", "flownetc.chairs-crop-b8")


def _cell(name):
    return load_cell(name) if name in INFER else unlisted_cell(name)


def _small(name):
    cell = _cell(name)
    if name in INFER:
        cell.traffic.update(height=128, width=192, pool_requests=2, check_requests=2, pairs_per_request=1)
    else:
        cell.traffic.update(samples=6, source_height=160, source_width=224, crop_height=128, crop_width=192, batch=2)
    return cell


def _fails(cell, numbers: dict) -> bool:
    return any(numbers[k] > limit for k, limit in cell.limits.items())


@pytest.mark.parametrize("name", INFER + TRAIN)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_where_the_program_passes(name, seed):
    cell = _small(name)
    got = (infer if name in INFER else train).readings(cell, seed, CPU, True)
    if name in INFER:
        program = {"flow_epe": max(x["flow_epe"] for x in got["program"])}
        control = {"flow_epe": max(x["flow_epe"] for x in got["control"])}
    else:
        program, control = got["program"][0], got["control"][0]
    assert not _fails(cell, program), program
    assert _fails(cell, control), control


@pytest.mark.gpu
@pytest.mark.parametrize("name", INFER + TRAIN)
def test_the_control_fails_at_the_cells_own_size_on_the_card(cuda, name):
    cell = _cell(name)
    module = infer if name in INFER else train
    for seed in SEEDS:
        got = module.readings(cell, seed, cuda, True)
        if name in INFER:
            program = {"flow_epe": max(x["flow_epe"] for x in got["program"])}
            control = {"flow_epe": max(x["flow_epe"] for x in got["control"])}
        else:
            program, control = got["program"][0], got["control"][0]
        assert not _fails(cell, program), (seed, program)
        assert _fails(cell, control), (seed, control)

"""The correctness check fails what it must: the control (the reference in
bfloat16 in the program's place) and the faults a cell can have, planted
in the timed path underneath a whole run on the CPU (the look for a card
skipped).  The program itself passes the same limits."""

import dataclasses
import time

import pytest
import torch

from portbench import control, run
from portbench.harness import manifest
from portbench.tests import small

M = manifest.manifest()


@pytest.fixture(autouse=True)
def one_request_window(monkeypatch):
    """On a shared CPU a window's seconds say nothing of how many requests
    finish in it: these runs' windows take one request, however long."""
    from portbench.harness import loops

    def window(cell, seconds, timed=False):
        start = time.perf_counter()
        result = cell.request(timed=timed)
        cell.record(result)
        return {"start": start, "requests": [(start, time.perf_counter())],
                "seconds": float("inf"), "work_each": cell.work_each}

    monkeypatch.setattr(loops, "window", window)


def _run(cell_name, cfg, traffic, seed=4, seconds=1.0):
    return run.run_cell(torch, cfg, traffic,
                        manifest.limits(cell_name), [],
                        manifest.end_to_end(M, cell_name), seed, seconds, 0,
                        device="cpu")


@pytest.mark.parametrize("cell_name,which", [
    ("shoebox_hall.wg", "shoebox"), ("columns_hall.wg", "columns")])
def test_render_program_passes(cell_name, which):
    r = _run(cell_name, getattr(small, which)(), small.traffic("wg"))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell_name,which,mix", [
    ("shoebox_hall.wg", "shoebox", "wg"), ("columns_hall.wg", "columns", "wg"),
    ("shoebox_hall.fit", "shoebox", "fit")])
def test_control_fails(cell_name, which, mix):
    from portbench.harness import check
    cfg = getattr(small, which)()
    traffic = small.traffic(mix)
    numbers = control.control_numbers(torch, cfg, traffic, 9, "cpu")
    correct, rows = check.judge(numbers, manifest.limits(cell_name))
    assert not correct, rows


def test_render_answer_altered_where_produced(monkeypatch):
    """One sample of each render's pressure changed by a hundredth of its
    peak, as the program returns it."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    real = wgrun.canonical

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        p = out.pressure.clone()
        p[len(p) // 2] += 1e-2 * p.abs().max()
        return dataclasses.replace(out, pressure=p)

    monkeypatch.setattr(wgrun, "canonical", altered)
    r = _run("shoebox_hall.wg", small.shoebox(), small.traffic("wg"))
    assert not r["correct"]
    assert r["checks"]["pressure_gap"]["value"] > \
        r["checks"]["pressure_gap"]["limit"]


def test_render_unstable_is_caught(monkeypatch):
    from wayverb_tpu_torch.waveguide import run as wgrun
    real = wgrun.canonical

    def unstable(*args, **kwargs):
        out = real(*args, **kwargs)
        return dataclasses.replace(out, stable=torch.tensor(False))

    monkeypatch.setattr(wgrun, "canonical", unstable)
    r = _run("columns_hall.wg", small.columns(), small.traffic("wg"))
    assert not r["correct"]


def test_fit_step_returning_its_state_unchanged(monkeypatch):
    def no_step(self):
        for t in (self.cb, self.ca, self.sig):
            t.grad = None

    monkeypatch.setattr(manifest.module("kinds", "fit").Cell, "step",
                        no_step)
    r = _run("shoebox_hall.fit", small.shoebox(), small.traffic("fit"))
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("leaf", [0, 1, 2], ids=["coef_b", "coef_a",
                                                  "signal"])
def test_fit_gradient_altered_where_produced(monkeypatch, leaf):
    """One leaf's gradient (the wall filters' numerators or denominators, or
    the signal) 1 % off as the program's backward returns it."""
    from wayverb_tpu_torch.waveguide import box_mega
    real = box_mega._MegaRun.backward

    def altered(ctx, gtaps, gstable):
        grads = list(real(ctx, gtaps, gstable))
        grads[leaf] = grads[leaf] * 1.01
        return tuple(grads)

    monkeypatch.setattr(box_mega._MegaRun, "backward", staticmethod(altered))
    r = _run("shoebox_hall.fit", small.shoebox(), small.traffic("fit"))
    assert not r["correct"]
    assert r["checks"]["grad_gap"]["value"] > \
        r["checks"]["grad_gap"]["limit"]


@pytest.mark.parametrize("fault", manifest.module("kinds", "fit").FAULTS)
def test_fit_planted_faults_fail(fault):
    """Each fault the control plants in the reference put in the program's
    place fails the fit's limits."""
    from portbench.harness import check
    numbers = control.control_numbers(torch, small.shoebox(),
                                      small.traffic("fit"), 9, "cpu",
                                      fault=fault)
    correct, rows = check.judge(numbers,
                                manifest.limits("shoebox_hall.fit"))
    assert not correct, rows


@pytest.mark.cuda
def test_card_runs_a_small_cell():
    """A small room through the whole run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run.run_cell(torch, small.shoebox(),
                     small.traffic("wg"), manifest.limits("shoebox_hall.wg"),
                     manifest.per_layer(M, "shoebox_hall.wg"),
                     manifest.end_to_end(M, "shoebox_hall.wg"), 2, 2.0, 1,
                     device="cuda")
    assert r["correct"] and r["device"]["busy_s"] > 0

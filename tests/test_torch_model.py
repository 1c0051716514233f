"""The port's project model, placement validation and all-pairs driver
against the JAX package's ``combined.{model,validate,complete}``, on the CPU.

Project files move both ways between the packages with equal ``to_dict()``;
presets and output names are the reference's; capsules build the port's
attenuators, whose gains match the reference's within 1e-6.  ``run_project``
renders a small project (two sources, one receiver with an omni and a
cardioid capsule) with the reference's random draws fed in: per pair
the tracer's directions of ``fold_in(key, i)``, per capsule the dirac draws
of ``fold_in(fold_in(key, i), j + 1)``.  The jointly normalised channels
agree within 1e-3 of the peak, the bound of ``test_torch_engine.py``'s
rendered IRs, and the files hold the channels to 24-bit quantisation.
A project with both ears of ``Hrtf`` equals the port's own ``Engine.run`` +
``render`` with the same generator, scaled by the joint peak, to the bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raytracer import reference_dirac_draws, reference_directions
from wayverb_tpu.combined import complete as jcomplete
from wayverb_tpu.combined import model as jmodel
from wayverb_tpu.combined import validate as jvalidate
from wayverb_tpu.core.geometry import Box as JBox
from wayverb_tpu.core.geometry import box_scene as j_box_scene
from wayverb_tpu_torch.combined import complete as tcomplete
from wayverb_tpu_torch.combined import engine as teng
from wayverb_tpu_torch.combined import model as tmodel
from wayverb_tpu_torch.combined import validate as tvalidate
from wayverb_tpu_torch.core.attenuator import Hrtf, Microphone
from wayverb_tpu_torch.core.geometry import Box, box_scene
from wayverb_tpu_torch.utils.audio import read_wav

torch.set_num_threads(2)

BOX = ((0.0, 0.0, 0.0), (3.0, 2.5, 2.2))
IR_REL = 1e-3


def _project(m, out_dir):
    """The same project built from either package's model module."""
    return m.Project(
        sources=[m.SourceModel("s1", (1.0, 1.2, 0.8)),
                 m.SourceModel("s2", (2.2, 0.9, 1.4))],
        receivers=[m.ReceiverModel(
            "r1", (2.0, 1.3, 1.5), capsules=[
                m.CapsuleModel("omni"),
                m.CapsuleModel("card", shape=0.5)])],
        materials=[m.MaterialModel("walls", [0.3] * 8, [0.1] * 8)],
        raytracer=m.RaytracerModel(rays=1 << 10, maximum_image_source_order=1),
        waveguide=m.WaveguideModel(cutoff=300.0),
        output=m.OutputModel(sample_rate=4000.0, output_directory=out_dir,
                             unique_id="proj"))


def test_project_json_both_ways(tmp_path):
    p = _project(tmodel, str(tmp_path))
    q = _project(jmodel, str(tmp_path))
    assert p.to_dict() == q.to_dict()
    mine, ref = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    p.save(mine)
    q.save(ref)
    with open(mine) as a, open(ref) as b:
        assert a.read() == b.read()
    assert jmodel.Project.load(mine).to_dict() == p.to_dict()
    assert tmodel.Project.load(ref).to_dict() == q.to_dict()
    assert tmodel.Project.load(mine).to_dict() == p.to_dict()
    d = tmodel.Project().to_dict()
    assert d == jmodel.Project().to_dict()
    assert tmodel.Project.from_dict(d).to_dict() == d


def test_presets_and_output_path():
    assert [m.__dict__ for m in tmodel.MATERIAL_PRESETS] == \
        [m.__dict__ for m in jmodel.MATERIAL_PRESETS]
    assert [c.__dict__ for c in tmodel.CAPSULE_PRESETS] == \
        [c.__dict__ for c in jmodel.CAPSULE_PRESETS]
    for m in (tmodel, jmodel):
        path = m.compute_output_path(
            m.SourceModel("s"), m.ReceiverModel("r"), m.CapsuleModel("omni"),
            m.OutputModel(output_directory="/out", unique_id="proj"))
        assert path == "/out/proj.s_s.r_r.c_omni.wav"
    assert tmodel.compute_output_path(
        tmodel.SourceModel("a"), tmodel.ReceiverModel("b"),
        tmodel.CapsuleModel("c"), tmodel.OutputModel()) == \
        "./out.s_a.r_b.c_c.wav"


def test_surface_table():
    p = tmodel.Project(materials=[tmodel.MaterialModel(),
                                  tmodel.MaterialModel("x", [0.5] * 8)])
    q = jmodel.Project(materials=[jmodel.MaterialModel(),
                                  jmodel.MaterialModel("x", [0.5] * 8)])
    got, want = p.surface_table(device="cpu"), q.surface_table()
    assert got.absorption.shape == (2, 8) and got.absorption.device.type \
        == "cpu"
    for g, w in ((got.absorption, want.absorption),
                 (got.scattering, want.scattering)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_capsule_builds_match(rng):
    dirs = rng.normal(size=(512, 3)).astype(np.float32)
    for t_cap, j_cap in zip(tmodel.CAPSULE_PRESETS + [tmodel.CapsuleModel(
            "hr", "hrtf", channel=1, pointing=[0.0, 1.0, 1.0])],
            jmodel.CAPSULE_PRESETS + [jmodel.CapsuleModel(
                "hr", "hrtf", channel=1, pointing=[0.0, 1.0, 1.0])]):
        got, want = t_cap.build(), j_cap.build()
        assert isinstance(got, Hrtf if t_cap.kind == "hrtf" else Microphone)
        np.testing.assert_allclose(
            got.attenuation(torch.from_numpy(dirs)).numpy(),
            np.asarray(want.attenuation(jnp.asarray(dirs))), rtol=0,
            atol=1e-6)
    with pytest.raises(ValueError, match="unknown capsule kind laser"):
        tmodel.CapsuleModel(kind="laser").build()


def test_validate_placements_strings():
    mesh = teng.Engine(box_scene(Box(*BOX)),
                       tmodel.Project().surface_table(device="cpu"),
                       teng.WaveguideParameters(cutoff=200.0),
                       scene_box=Box(*BOX), device="cpu").mesh
    assert tvalidate.MIN_SPACING == jvalidate.MIN_SPACING == 0.2
    near = [(1.0, 1.0, 1.0), (1.0, 1.0, 1.15)]
    assert not tvalidate.is_pairwise_distance_acceptable(near)
    assert tvalidate.is_pairwise_distance_acceptable(near, min_spacing=0.1)
    assert tvalidate.is_pairwise_distance_acceptable(
        near, 0.1) == jvalidate.is_pairwise_distance_acceptable(near, 0.1)
    with pytest.raises(RuntimeError, match="^source and receiver positions "
                       "are too close together$"):
        tvalidate.validate_placements(near[:1], near[1:], mesh)
    with pytest.raises(RuntimeError, match="does not map to an inside mesh "
                       "node"):
        tvalidate.validate_placements([(10.0, 10.0, 10.0)], [(2.0, 1.3, 1.5)],
                                      mesh)
    tvalidate.validate_placements([(1.0, 1.2, 0.8)], [(2.0, 1.3, 1.5)], mesh)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """Both packages' ``run_project`` on the same project, the port fed the
    reference's draws."""
    jdir = str(tmp_path_factory.mktemp("ref"))
    tdir = str(tmp_path_factory.mktemp("port"))
    key = jax.random.PRNGKey(0)
    jstates, tstates = [], []
    want = jcomplete.run_project(
        _project(jmodel, jdir), j_box_scene(JBox(*BOX)), key,
        scene_box=JBox(*BOX), state_callback=lambda s, p: jstates.append(s))
    project = _project(tmodel, tdir)
    depth = teng.optimum_depth(project.surface_table(device="cpu"))
    pairs = [(s, r) for s in project.sources for r in project.receivers]
    directions, draws = [], []
    for i, (_, rcv) in enumerate(pairs):
        pair_key = jax.random.fold_in(key, i)
        directions.append(reference_directions(
            pair_key, project.raytracer.rays, depth))
        draws.append([None] * len(rcv.capsules))
    # the tail's length is the histogram's: read it from the reference's
    # channels' length at the output rate
    n = want[0].signal.shape[0]
    for i, (_, rcv) in enumerate(pairs):
        pair_key = jax.random.fold_in(key, i)
        for j in range(len(rcv.capsules)):
            draws[i][j] = reference_dirac_draws(
                jax.random.fold_in(pair_key, j + 1), n)
    got = tcomplete.run_project(
        project, box_scene(Box(*BOX)), None, scene_box=Box(*BOX),
        state_callback=lambda s, p: tstates.append(s), device="cpu",
        directions=directions, draws=draws)
    return want, got, jstates, tstates


def test_run_project_matches_reference(rendered):
    want, got, jstates, tstates = rendered
    assert len(got) == len(want) == 4
    assert tstates == jstates
    assert tstates[0] == "initialising" and tstates[-1] == "done"
    peak = max(np.abs(c.signal).max() for c in got)
    assert peak == pytest.approx(1.0, abs=1e-7)
    for g, w in zip(got, want):
        assert (g.source, g.receiver, g.capsule) == \
            (w.source, w.receiver, w.capsule)
        assert os.path.basename(g.path) == os.path.basename(w.path)
        assert g.signal.shape == w.signal.shape
        assert g.signal.dtype == w.signal.dtype == np.float32
        assert np.all(np.isfinite(g.signal))
        np.testing.assert_allclose(g.signal, w.signal, rtol=0, atol=IR_REL)
    # the cardioid and the omni differ: the capsules are rendered apart
    assert np.abs(got[1].signal - got[0].signal).max() > IR_REL


def test_run_project_files(rendered):
    """Each channel's file, read back, holds the channel to 24-bit
    quantisation (the project's ``pcm24``)."""
    _, got, _, _ = rendered
    for c in got:
        data, rate = read_wav(c.path)
        assert rate == 4000.0 and data.shape == (1, c.signal.shape[0])
        np.testing.assert_allclose(data[0], c.signal, rtol=0,
                                   atol=1.0 / 8388607)


def test_run_project_with_both_ears_equals_engine_and_render(tmp_path):
    project = tmodel.Project(
        sources=[tmodel.SourceModel("s", (1.0, 1.2, 0.8))],
        receivers=[tmodel.ReceiverModel("r", (2.0, 1.3, 1.5), capsules=[
            tmodel.CapsuleModel("left", "hrtf", channel=0),
            tmodel.CapsuleModel("right", "hrtf", channel=1)])],
        materials=[tmodel.MaterialModel("walls", [0.3] * 8, [0.1] * 8)],
        raytracer=tmodel.RaytracerModel(rays=256,
                                        maximum_image_source_order=1),
        waveguide=tmodel.WaveguideModel(cutoff=200.0),
        output=tmodel.OutputModel(sample_rate=2000.0,
                                  output_directory=str(tmp_path)))
    got = tcomplete.run_project(project, box_scene(Box(*BOX)),
                                torch.Generator().manual_seed(3),
                                scene_box=Box(*BOX), device="cpu")
    e = teng.Engine(box_scene(Box(*BOX)), project.surface_table(device="cpu"),
                    teng.WaveguideParameters(cutoff=200.0),
                    scene_box=Box(*BOX), device="cpu")
    gen = torch.Generator().manual_seed(3)
    results = e.run((1.0, 1.2, 0.8), (2.0, 1.3, 1.5), gen,
                    teng.RaytracerParameters(rays=256,
                                             maximum_image_source_order=1))
    irs = [teng.render(results, Hrtf(channel=c), 2000.0, gen).numpy()
           for c in (0, 1)]
    scale = 1.0 / max(np.abs(ir).max() for ir in irs)
    assert [c.capsule for c in got] == ["left", "right"]
    for c, ir in zip(got, irs):
        np.testing.assert_array_equal(c.signal, ir * scale)
        assert os.path.exists(c.path)
    assert np.abs(irs[0] - irs[1]).max() > 0


def test_bad_placement_raises():
    for where in ((10.0, 10.0, 10.0), (2.0, 1.3, 1.45)):
        project = tmodel.Project(
            sources=[tmodel.SourceModel("s1", where)],
            receivers=[tmodel.ReceiverModel("r1", (2.0, 1.3, 1.5))],
            waveguide=tmodel.WaveguideModel(cutoff=200.0))
        with pytest.raises(RuntimeError):
            tcomplete.run_project(project, box_scene(Box(*BOX)),
                                  torch.Generator().manual_seed(0),
                                  scene_box=Box(*BOX), write_files=False,
                                  device="cpu")


def test_run_project_runs_on_the_card_by_default():
    """Without ``device=`` the project renders on the card; with no GPU
    that raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card run is chip_smoke.py's")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        tcomplete.run_project(tmodel.Project(), box_scene(Box(*BOX)),
                              scene_box=Box(*BOX), write_files=False)

"""The port's interactive front end (``wayverb_tpu_torch/tools/gui.py``) on
the CPU, through its HTTP API as ``tests/test_gui.py`` drives the
reference's: load a scene, render (the hybrid pipeline with progress), the
IR, rays, wavefront and WAV, then a cancel; and its two capture helpers
against the reference's (``tools/gui.py``).

Tolerances: the wavefront frames within one quantisation unit (a frame is
quantised to ±127 of its peak, so rounding can land one unit apart) and the
extents equal; the ray polylines within 1e-5 m with the reference's draws
(a dense 12-triangle box: the same paths).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raytracer import reference_directions
from wayverb_tpu_torch.tools import gui
from wayverb_tpu_torch.utils.audio import read_wav

torch.set_num_threads(2)

BOX = (4.0, 3.0, 3.5)
SOURCE, RECEIVER = (1.0, 1.2, 0.9), (2.8, 1.4, 2.4)


@pytest.fixture(scope="module")
def server():
    httpd = gui.serve(port=0, device="cpu")           # ephemeral port
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()
    httpd.server_close()


def _post(base, path, obj):
    req = urllib.request.Request(base + path,
                                 data=json.dumps(obj).encode(),
                                 method="POST")
    return json.loads(urllib.request.urlopen(req).read())


def _get(base, path):
    return urllib.request.urlopen(base + path).read()


def _wait(base, seconds=600):
    deadline = time.time() + seconds
    while True:
        p = json.loads(_get(base, "/api/progress"))
        if not p["running"]:
            return p
        assert time.time() < deadline, "render timed out"
        time.sleep(0.2)


def test_full_loop(server, tmp_path):
    """load → render → progress → result → WAV, then a cancel."""
    page = _get(server, "/").decode()
    assert "wayverb_tpu_torch" in page and "api/render" in page

    sc = _post(server, "/api/load", {"dims": [3.2, 2.5, 2.8]})
    assert sc["num_triangles"] == 12 and sc["is_box"]
    np.testing.assert_allclose(sc["bounds"], [[0, 0, 0], [3.2, 2.5, 2.8]],
                               rtol=1e-6)

    r = _post(server, "/api/render", {
        "source": [1.0, 1.2, 0.9], "receiver": [2.2, 1.4, 1.9],
        "rays": 256, "cutoff": 200, "absorption": 0.2})
    assert r["started"]
    p = _wait(server)
    assert p["status"] == "done", p
    assert p["error"] is None and p["has_result"] and p["progress"] == 1.0

    res = json.loads(_get(server, "/api/result"))
    ir = np.asarray(res["ir"])
    assert ir.size > 100 and np.all(np.isfinite(ir))
    assert np.max(np.abs(ir)) > 0
    assert res["channels"] == 1 and res["sample_rate"] == 44100.0
    assert len(res["rays"]) == 48 and len(res["rays"][0]) == 7
    assert len(res["rays"][0][0]) == 3
    assert len(res["frames"]) == 20 and res["frame_extent"]
    assert max(abs(v) for f in res["frames"] for row in f for v in row) == 127

    wav = _get(server, "/api/result.wav")
    assert wav[:4] == b"RIFF" and len(wav) > 1000
    path = tmp_path / "result.wav"
    path.write_bytes(wav)
    data, sr = read_wav(str(path))
    assert sr == 44100.0 and data.shape[0] == 1
    assert np.all(np.isfinite(data)) and np.abs(data).max() > 0

    _post(server, "/api/load", {"dims": list(BOX)})
    r = _post(server, "/api/render", {
        "source": list(SOURCE), "receiver": list(RECEIVER),
        "rays": 256, "cutoff": 200, "absorption": 0.3})
    assert r["started"]
    _post(server, "/api/cancel", {})
    p = _wait(server)
    assert p["status"] in ("cancelled", "done")


def test_render_error_shows_in_progress(server):
    """A render that raises (a source outside the room) ends as status
    ``"error"`` with its traceback, as the reference's worker does."""
    _post(server, "/api/load", {"dims": list(BOX)})
    r = _post(server, "/api/render", {
        "source": [9.0, 1.2, 0.9], "receiver": list(RECEIVER),
        "rays": 256, "cutoff": 200})
    assert r["started"]
    p = _wait(server)
    assert p["status"] == "error" and "Traceback" in p["error"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(server, "/api/result")
    assert err.value.code == 404


def test_serve_runs_on_the_card_unless_told():
    """Without a device the server renders on the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the server would use it")
    with pytest.raises(RuntimeError, match="--cpu"):
        gui.serve(port=0)


def _scenes():
    from tools import gui as ref_gui
    from wayverb_tpu.core.geometry import Box as JBox
    from wayverb_tpu.core.geometry import box_scene as j_box_scene
    from wayverb_tpu_torch.core.geometry import Box, box_scene
    jbox, box = JBox((0.0, 0.0, 0.0), BOX), Box((0.0, 0.0, 0.0), BOX)
    return ref_gui, (j_box_scene(jbox), jbox), (box_scene(box), box)


def test_capture_wavefront_matches_reference():
    """Every frame within one quantisation unit, the extents equal."""
    ref_gui, (jsoup, jbox), (soup, box) = _scenes()
    absorption = np.full((1, 8), 0.2)
    want, want_extent = ref_gui._capture_wavefront(jsoup, absorption, jbox,
                                                   SOURCE, RECEIVER)
    got, extent = gui._capture_wavefront(soup, absorption, box, SOURCE,
                                         RECEIVER, torch.device("cpu"))
    assert extent == want_extent
    assert len(got) == len(want) == 20
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert np.abs(got).max() == 127


def test_capture_wavefront_outside_the_room():
    """A position that maps to no inside node gives (None, None)."""
    from wayverb_tpu_torch.core.geometry import Box, box_scene
    box = Box((0.0, 0.0, 0.0), BOX)
    assert gui._capture_wavefront(box_scene(box), np.full((1, 8), 0.2), box,
                                  (9.0, 1.0, 1.0), RECEIVER,
                                  torch.device("cpu")) == (None, None)


def test_capture_rays_matches_reference():
    """(48, 7, 3) polylines from the source, within 1e-5 m of the
    reference's with its draws."""
    from wayverb_tpu.core.surfaces import Surface as JSurface
    from wayverb_tpu_torch.core.surfaces import Surface
    ref_gui, (jsoup, _), (soup, _) = _scenes()
    key = jax.random.PRNGKey(3)
    want = ref_gui._capture_rays(
        jsoup, JSurface(absorption=jnp.full((1, 8), 0.2),
                        scattering=jnp.full((1, 8), 0.1)),
        SOURCE, RECEIVER, key)
    got = gui._capture_rays(
        soup, Surface(absorption=torch.full((1, 8), 0.2),
                      scattering=torch.full((1, 8), 0.1)),
        SOURCE, RECEIVER, None, torch.device("cpu"),
        directions=reference_directions(key, 48, 6))
    assert got.shape == want.shape == (48, 7, 3)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

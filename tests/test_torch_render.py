"""nbody_tpu_torch's renderer and live viewer against nbody_tpu's: the
colormap, the projection, both composite modes and the PPM bytes on the
same numpy inputs; the orbit camera; the viewer's endpoints on the CPU."""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from nbody_tpu.init import disk_galaxy_msvc
from nbody_tpu.viz import render as jrender

from nbody_tpu_torch import config as tcfg
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.viz import render as trender
from nbody_tpu_torch.viz.viewer import SimViewer, serve

torch.set_num_threads(2)

CAMERAS = [(4000.0, 30.0, 45.0), (2500.0, -70.0, 200.0),
           (6000.0, 12.5, -33.3)]


def _cloud(n=20_000):
    st = disk_galaxy_msvc(n)
    return np.array(st.pos), 3.0 * np.array(st.vel)


def test_speed_colormap_matches_jax():
    _, vel = _cloud()
    vel[:3] = [[0, 0, 0], [150.0, 0, 0], [9999.0, 0, 0]]
    got = trender.speed_colormap(torch.as_tensor(vel)).numpy()
    want = np.asarray(jrender.speed_colormap(jnp.asarray(vel)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(got[0], [0.4, 0.3, 1.0], atol=1e-6)
    np.testing.assert_allclose(got[2], got[1], atol=1e-6)


@pytest.mark.parametrize("cam", CAMERAS)
def test_project_matches_jax(cam):
    """Pixels and visibility equal; eye depth within a float32 ulp (the
    port applies the rotation as scalar multiply-adds)."""
    pos, _ = _cloud()
    want = [np.asarray(x) for x in jrender.project(jnp.asarray(pos), *cam,
                                                   320, 180)]
    got = [x.numpy() for x in trender.project(torch.as_tensor(pos), *cam, 320,
                                              180)]
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], rtol=2.4e-7)
    assert want[3].sum() > 1000


@pytest.mark.parametrize("mode", ["add", "depth"])
@pytest.mark.parametrize("cam", CAMERAS)
def test_render_frame_matches_jax(mode, cam):
    """Every pixel within 2.4e-7 (two float32 ulps at 1): colours differ
    by an ulp, and the adds into a pixel come in another order."""
    pos, vel = _cloud()
    want = np.asarray(jrender.render_frame(jnp.asarray(pos), jnp.asarray(vel),
                                           *cam, 320, 180, mode))
    got = trender.render_frame(torch.as_tensor(pos), torch.as_tensor(vel),
                               *cam, 320, 180, mode).numpy()
    assert got.shape == (180, 320, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    assert (want > 0).sum() > 1000


def test_render_frame_depth_nearest_wins_and_bad_mode():
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 100.0]])
    vel = torch.tensor([[0.0, 0.0, 0.0], [300.0, 0.0, 0.0]])
    f = trender.render_frame(pos, vel, 4000.0, 0.0, 0.0, 64, 64, mode="depth")
    np.testing.assert_allclose(f[32, 32].numpy(), [1.0, 0.7, 0.3], atol=1e-5)
    with pytest.raises(ValueError):
        trender.render_frame(pos, vel, 4000.0, 0.0, 0.0, 64, 64, mode="max")


def test_render_state_and_write_ppm_bytes_match_jax(tmp_path):
    """render_state reads the config's camera and size; write_ppm of the
    same float32 frame writes JAX's bytes."""
    pos, vel = _cloud(5000)
    cfg = tcfg.SimConfig(n=5000, render_width=96, render_height=64)
    st = ParticleState.create(pos, vel, np.ones(5000, np.float32))
    frame = trender.render_state(st, cfg, mode="add", exposure=0.7)
    want = jrender.render_frame(jnp.asarray(pos), jnp.asarray(vel), 4000.0,
                                30.0, 45.0, 96, 64, "add", 0.7)
    np.testing.assert_allclose(frame.numpy(), np.asarray(want), atol=2.4e-7)
    frame = np.asarray(want) * 1.3 - 0.1          # values outside [0, 1]
    pt, pj = tmp_path / "t.ppm", tmp_path / "j.ppm"
    trender.write_ppm(str(pt), torch.as_tensor(frame))
    jrender.write_ppm(str(pj), jnp.asarray(frame))
    assert pt.read_bytes() == pj.read_bytes()
    assert pt.read_bytes().startswith(b"P6 96 64 255\n")


def test_orbit_camera():
    cfg = tcfg.SimConfig(n=8)
    cam = trender.OrbitCamera(cfg)
    assert (cam.distance, cam.rot_x, cam.rot_y) == (4000.0, 30.0, 45.0)
    cam.drag(10, -5)
    cam.scroll(2)
    assert cam.rot_y == pytest.approx(47.0)
    assert cam.rot_x == pytest.approx(29.0)
    assert cam.distance == pytest.approx(3700.0)


# --- the live viewer on the CPU ---------------------------------------------


@pytest.fixture(scope="module")
def viewer_server():
    cfg = tcfg.SimConfig(n=512, use_pallas=False, render_width=160,
                         render_height=96, check_overflow=False)
    sim = Simulation(cfg, method="barnes_hut", device="cpu")
    viewer = SimViewer(sim, sim.init_state(), cfg, steps_per_frame=2)
    viewer.start()
    server = serve(viewer, port=0)  # OS-assigned free port
    url = f"http://127.0.0.1:{server.server_address[1]}"
    yield viewer, url
    server.shutdown()
    server.server_close()
    viewer.stop()


def _get(url, timeout=60.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _post(url, msg):
    req = urllib.request.Request(url + "/cam", data=json.dumps(msg).encode(),
                                 method="POST")
    urllib.request.urlopen(req, timeout=30).read()


def test_viewer_page_frame_stats_and_stream(viewer_server):
    viewer, url = viewer_server
    status, ctype, body = _get(url + "/")
    assert status == 200 and "text/html" in ctype
    assert b"/stream" in body and b"mousedown" in body
    status, ctype, body = _get(url + "/frame.jpg")
    assert status == 200 and ctype == "image/jpeg"
    assert body[:2] == b"\xff\xd8"
    assert Image.open(io.BytesIO(body)).size == (160, 96)
    stats = json.loads(_get(url + "/stats")[2])
    assert stats["n"] == 512 and stats["step"] >= 2 and stats["frames"] >= 1
    req = urllib.request.urlopen(url + "/stream", timeout=60)
    assert "multipart/x-mixed-replace" in req.headers.get("Content-Type", "")
    buf = b""
    while b"\xff\xd9" not in buf and len(buf) < 4_000_000:
        chunk = req.read(4096)
        if not chunk:
            break
        buf += chunk
    req.close()
    assert b"--frame" in buf and b"\xff\xd8" in buf
    assert _get(url + "/stats")[0] == 200
    with pytest.raises(urllib.error.HTTPError):
        _get(url + "/nothing")


def test_viewer_camera_mouse_parity(viewer_server):
    """Drag = 0.2 deg/px, wheel = 150 per click (nbody_v5.cu:460-469)."""
    viewer, url = viewer_server
    d0 = viewer.stats()
    _post(url, {"drag_dx": 10, "drag_dy": -5})
    _post(url, {"scroll": 1})
    s = viewer.stats()
    assert s["rot_y"] == pytest.approx(d0["rot_y"] + 10 * 0.2)
    assert s["rot_x"] == pytest.approx(d0["rot_x"] - 5 * 0.2)
    assert s["distance"] == pytest.approx(d0["distance"] - 150.0)
    _post(url, {"scroll": -10_000})
    assert viewer.stats()["distance"] == 5.0e5        # clamped
    _post(url, {"reset": 1})
    assert viewer.stats()["distance"] == pytest.approx(4000.0)


def test_viewer_advances_the_adaptive_stepper():
    """At a band-reuse config the sim thread advances make_stepper's
    stepper and renders its Morton-ordered arrays; stop() folds its state
    back in the original order."""
    cfg = tcfg.PRESETS["v5"].replace(n=1500, use_pallas=False,
                                     render_width=64, render_height=48)
    sim = Simulation(cfg, device="cpu")
    st0 = sim.init_state()
    viewer = SimViewer(sim, st0, cfg, steps_per_frame=2)
    assert viewer._stepper is not None
    viewer.start()
    try:
        assert viewer.wait_frame()[:2] == b"\xff\xd8"
    finally:
        viewer.stop()
    assert viewer.stats()["step"] >= 2
    assert viewer._stepper.steps_done >= 2
    assert viewer.state.n == 1500 and torch.isfinite(viewer.state.pos).all()
    assert not torch.equal(viewer.state.pos, st0.pos)


def test_viewer_reports_a_failed_sim_thread():
    class Broken:
        def make_stepper(self, state):
            return None

        def run_scan(self, state, n):
            raise ValueError("step failed")

    cfg = tcfg.SimConfig(n=16, render_width=8, render_height=8)
    viewer = SimViewer(Broken(), ParticleState.create(
        np.zeros((16, 3)), np.zeros((16, 3)), np.ones(16)), cfg)
    viewer.start()
    with pytest.raises(RuntimeError, match="sim thread failed"):
        viewer.wait_frame(timeout=30)
    with pytest.raises(RuntimeError, match="sim thread failed"):
        viewer.stop()

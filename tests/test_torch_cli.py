"""The port's command line (vpt_tpu_torch.cli), mirroring tests/test_cli.py
on ``--device cpu`` with ``.npy`` outputs, plus its exits for what is not
ported and for a missing CUDA. Runs in-process."""

import json
import os

import numpy as np
import pytest
import torch

from vpt_tpu_torch.cli import main

SMALL = ["--device", "cpu", "--volume-size", "16", "--resolution", "16", "--frames", "2",
         "--steps", "4"]


def _run(capsys, argv):
    main(argv)
    return capsys.readouterr()


def test_renderers_and_tonemappers_lists(capsys):
    assert _run(capsys, ["renderers"]).out.split() == ["depth", "dos", "eam", "iso", "lao",
                                                       "mcm", "mcm-spectral", "mcs", "mip"]
    out = _run(capsys, ["tonemappers"]).out
    for key in ("artistic", "reinhard", "aces", "uchimura", "lottes"):
        assert key in out


def test_info_reports_torch_not_jax(capsys):
    info = json.loads(_run(capsys, ["info"]).out)
    assert info["torch"] == torch.__version__ and "jax" not in info
    assert info["cuda_available"] == torch.cuda.is_available()


def test_render_to_npy_and_checkpoint(tmp_path, capsys):
    out, ck = str(tmp_path / "out.npy"), str(tmp_path / "state.npz")
    res = _run(capsys, ["render", *SMALL, "--output", out, "--checkpoint", ck])
    img = np.load(out)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8 and os.path.exists(ck)
    metrics = json.loads(res.out.strip().splitlines()[-1])
    assert metrics["frames"] == 2 and metrics["paths"] > 0 and metrics["device"] == "cpu"
    assert int(np.load(ck)["frame"]) == 2


def test_render_spectral_compaction(tmp_path, capsys):
    out = str(tmp_path / "compact.npy")
    res = _run(capsys, ["render", *SMALL, "--streams", "2", "--compaction",
                        "--majorant-blocks", "4", "--output", out])
    assert np.load(out).shape == (16, 16, 3)
    assert json.loads(res.out.strip().splitlines()[-1])["paths"] > 0


def test_render_spectral_with_envmap(tmp_path, capsys):
    env = str(tmp_path / "env.npy")
    np.save(env, np.ones((4, 8, 3), np.float32))
    out = str(tmp_path / "env_render.npy")
    _run(capsys, ["render", *SMALL, "--envmap", env, "--output", out])
    assert np.load(out).shape == (16, 16, 3)


def test_animate(tmp_path, capsys):
    outdir = str(tmp_path / "anim")
    _run(capsys, ["animate", "--device", "cpu", "--volume-size", "16", "--resolution", "16",
                  "--frames", "1", "--steps", "4", "--n-frames", "2", "--output", outdir])
    assert len(os.listdir(outdir)) == 2


def test_invert_spectral_prb(tmp_path, capsys):
    out = str(tmp_path / "rec.npy")
    captured = _run(capsys, [
        "invert", "--spectral", "--device", "cpu", "--volume-size", "16", "--resolution",
        "16", "--iterations", "2", "--method", "prb", "--scatter-stride", "2",
        "--scatter-mode", "importance", "--output", out])
    metrics = json.loads(captured.out.strip().splitlines()[-1])
    assert np.isfinite(metrics["final_loss"]) and np.isfinite(metrics["density_mae"])
    assert np.load(out).shape == (16, 16, 16)


def test_invert_spectral_autodiff(tmp_path, capsys):
    out = str(tmp_path / "rec_autodiff.npy")
    captured = _run(capsys, [
        "invert", "--spectral", "--device", "cpu", "--volume-size", "8", "--resolution", "8",
        "--iterations", "2", "--method", "autodiff", "--output", out])
    metrics = json.loads(captured.out.strip().splitlines()[-1])
    assert np.isfinite(metrics["final_loss"]) and np.isfinite(metrics["density_mae"])
    assert np.load(out).shape == (8, 8, 8)


def test_invert_eam_matches_jax(tmp_path, capsys):
    """invert without --spectral (EAM fit_density) at 8^3 / 8^2 for 2
    iterations: JAX's JSON keys, its numbers (rtol 1e-4: the two packages
    sum in other orders), the recovered grid's shape."""
    from vpt_tpu.cli import main as jax_main

    argv = ["invert", "--volume-size", "8", "--resolution", "8", "--iterations", "2"]
    out, out_j = str(tmp_path / "rec.npy"), str(tmp_path / "rec_jax.npy")
    metrics = json.loads(_run(capsys, [*argv, "--device", "cpu", "-o", out]).out
                         .strip().splitlines()[-1])
    jax_main([*argv, "-o", out_j])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) == set(want) == {"final_loss", "density_mae"}
    for key in want:
        assert metrics[key] == pytest.approx(want[key], rel=1e-4), key
    rec = np.load(out)
    assert rec.shape == (8, 8, 8) and rec.dtype == np.float32
    np.testing.assert_allclose(rec, np.load(out_j), atol=1e-4)


@pytest.mark.parametrize("argv,names", [
    pytest.param(["render", "--devices", "2"], "--devices", id="argv1---devices"),
    # every renderer is ported; the id stays, the case now checks the other
    # subcommand that builds a mesh (animate on mcm-spectral with --devices)
    pytest.param(["animate", "--devices", "2"], "--devices", id="argv2-mcm"),
])
def test_exits_name_what_is_not_ported(argv, names, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        main([*argv, "--device", "cpu", "--volume-size", "8", "--resolution", "8",
              "--frames", "1", "-o", str(tmp_path / "x.npy")])
    assert names in str(e.value.code) and "not ported" in str(e.value.code)
    assert not os.path.exists(tmp_path / "x.npy")


def test_invert_spectral_ignores_the_renderer_as_jax(tmp_path, capsys):
    """invert --spectral fits mcm-spectral whatever --renderer says, as
    vpt_tpu's CLI does: at 16^3 / 16^2 for 2 iterations, JAX's JSON keys, its
    numbers (rtol 1e-4: the two packages round the fit's sums in other
    orders) and its recovered grid (atol 1e-4)."""
    from vpt_tpu.cli import main as jax_main

    argv = ["invert", "--spectral", "--renderer", "eam", "--volume-size", "16", "--resolution",
            "16", "--iterations", "2"]
    out, out_j = str(tmp_path / "rec.npy"), str(tmp_path / "rec_jax.npy")
    metrics = json.loads(_run(capsys, [*argv, "--device", "cpu", "-o", out]).out
                         .strip().splitlines()[-1])
    jax_main([*argv, "-o", out_j])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) == set(want) == {"final_loss", "density_mae", "init_density_mae"}
    for key in want:
        assert metrics[key] == pytest.approx(want[key], rel=1e-4), key
    rec = np.load(out)
    assert rec.shape == (16, 16, 16) and rec.dtype == np.float32
    np.testing.assert_allclose(rec, np.load(out_j), atol=1e-4)


def test_devices_is_ignored_off_mcm_spectral(tmp_path, capsys):
    """render --renderer eam --devices 2 runs on one device, as vpt_tpu's
    CLI does (it builds a mesh for mcm-spectral only): the image equals
    --devices 1's bit for bit."""
    outs = []
    for n in ("1", "2"):
        out = str(tmp_path / f"eam{n}.npy")
        metrics = json.loads(_run(capsys, ["render", *SMALL, "--renderer", "eam", "--devices", n,
                                           "--output", out]).out.strip().splitlines()[-1])
        assert metrics["frames"] == 2 and metrics["device"] == "cpu"
        outs.append(np.load(out))
    assert outs[0].shape == (16, 16, 3) and outs[0].any()
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("cmd", ["render", "invert", "invert-eam"])
def test_cuda_device_without_cuda_exits_nonzero(cmd, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [cmd.split("-")[0], "--volume-size", "8", "--resolution", "8", "-o",
            str(tmp_path / "x.npy")]
    if cmd == "invert":
        argv.append("--spectral")
    with pytest.raises(SystemExit) as e:
        main(argv)  # --device defaults to cuda
    assert e.value.code not in (0, None) and "CUDA is not available" in str(e.value.code)
    assert not os.path.exists(tmp_path / "x.npy")


def test_profile_fit_exits_without_cuda(monkeypatch, capsys):
    """The fit profiler measures the card only: without CUDA it exits 1."""
    from vpt_tpu_torch.tools import profile_fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        profile_fit.main([])
    assert e.value.code == 1 and "CUDA" in capsys.readouterr().err

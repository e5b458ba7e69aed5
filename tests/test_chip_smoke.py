"""Rehearsal of ``chip_smoke.py``: every phase function at a tiny size on
the active backend (the CPU here), plus the refusal to run without a GPU.

The phases run their own checks (reference errors beside limits, overflow,
finiteness, mass, exact counts) and raise on any failure."""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(
    mpm=dict(n=4096, dx=1 / 32, bins=128, blocks=512, chunk=32, steps=3,
             n_big=8192, dx_big=1 / 64, bins_big=256, blocks_big=1024,
             chunk_big=64, steps_big=4),
    prims=dict(n=3 * 4096 + 77),
    lbvh=dict(n=4096, n_sample=256),
    reach=dict(implicit=dict(n=4096, dx=1 / 32, bins=128, blocks=512,
                             chunk=32),
               fluid=dict(n=4096, bins=128, chunk=32), cloth_nx=8,
               terrain_res=4),
)


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_rehearsal(phase):
    fn = {"mpm": cs.phase_mpm, "prims": cs.phase_prims,
          "lbvh": cs.phase_lbvh, "reach": cs.phase_reach}[phase]
    fn(**TINY[phase])


def test_cards_rehearsal():
    """The --cards path on 4 virtual devices: both multi-device tiers
    against the one-device reference."""
    cs.phase_cards(4, n=4096, dx=1 / 32, blocks=512, steps=2,
                   nb_local=256, mig_cap=512)


def test_full_sizes_cover_every_phase():
    assert set(cs.FULL) == set(TINY) | {"cards"}
    for phase, kw in TINY.items():
        assert set(cs.FULL[phase]) == set(kw), phase


def test_require_gpu():
    dev = jax.devices()[0]
    if dev.platform == "gpu":
        assert cs.require_gpu() is dev
    else:
        with pytest.raises(SystemExit) as e:
            cs.require_gpu()
        assert "no GPU found" in str(e.value.code)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_refuses_cpu(script):
    """On the CPU both scripts exit nonzero with a message and print no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       capture_output=True, text=True, env=env,
                       timeout=300, cwd=REPO)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert r.stdout.strip() == ""

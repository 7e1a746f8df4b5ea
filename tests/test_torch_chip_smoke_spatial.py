"""chip_smoke.py's phase 39 (spatial sharding on gloo ranks) rehearsed on
the CPU: the tiny configs, K1 and K2 counted in their plain versions, the
unsharded references in this process and the 2 and 3 ranks as their own
processes, as the phase runs them on the card."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def space_phase_on_the_cpu(monkeypatch, tmp_path):
    from futuredet_torch.ops import pallas_gather, pallas_nms
    monkeypatch.setattr(cs, "SPACE_REHEARSAL", True)
    for mod, name, wrapper in (
            (pallas_nms, "nms_alive_plain", pallas_nms.rotate_nms_alive),
            (pallas_gather, "gather_conv_plain", pallas_gather.gather_conv)):
        def counted(*args, plain=getattr(mod, name), wrapper=wrapper):
            wrapper.launches += 1
            return plain(*args)
        monkeypatch.setattr(mod, name, counted)
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield lines
    torch.set_num_threads(n)


def test_space_phase_rehearses_on_the_cpu(space_phase_on_the_cpu, tmp_path):
    lines = space_phase_on_the_cpu
    got = cs.space_path(torch.device("cpu"), "cpu", str(tmp_path))
    pp, vox = cs.NAME, cs.VOX_NAME
    assert got == {f"{pp}_space2_pp_eval": {"k1": 1, "k2": 0},
                   f"{vox}_space2_vox_eval": {"k1": 1, "k2": 40},
                   f"{pp}_space2_pp_train": {"k1": 0, "k2": 0},
                   f"{vox}_space2_vox_train": {"k1": 0, "k2": 78},
                   f"{pp}_space3_pp_eval": {"k1": 1, "k2": 0}}
    assert [ln["ranks"] for ln in lines] == [2, 3]
    for ln in lines:
        assert ln["phase"] == "spatial_sharding"
        assert ln["backend"] == "gloo" and ln["ranks_on"] == ["cpu"]
    two = lines[0]
    assert two["vox_train"]["launches"] == [
        {"k1": 0, "k2": 39, "k2_dx": 19}] * 2
    assert two["pp_eval"]["max_abs_err"] <= cs.SPACE_RTOL * 10
    assert all(b > 0 for b in two["pp_train"]["halo_bytes"])

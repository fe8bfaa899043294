"""The frozen twin generator and BAL writer against the port's own."""

import numpy as np
import pytest

from portbench import twin
from rootba_tpu_torch.bal.problem import load_bal
from rootba_tpu_torch.bal.synthetic import (
    generate_synthetic_bal,
    write_bal_file,
)

KNOBS = dict(track_sigma=1.1, window_stretch=3.0, p_far=0.03,
             max_window_frac=0.08)


@pytest.mark.parametrize("seed", [17, 2 ** 31 + 12345])
def test_twin_is_the_ports_bit_for_bit(seed, tmp_path):
    want = generate_synthetic_bal(num_cams=60, num_lms=900,
                                  mean_obs_per_lm=4000 / 900,
                                  pixel_noise=1.0, seed=seed,
                                  structure="clustered", **KNOBS)
    got = twin.generate(60, 900, 4000, seed, **KNOBS)
    for k, v in got.items():
        ref = getattr(want, k)
        assert v.dtype == ref.dtype and np.array_equal(v, ref), k
    write_bal_file(want, str(tmp_path / "port.txt"))
    twin.write_bal(got, str(tmp_path / "frozen.txt"))
    assert ((tmp_path / "port.txt").read_bytes()
            == (tmp_path / "frozen.txt").read_bytes())


def test_order_seed_reorders_lines_of_the_same_problem(tmp_path):
    t = twin.generate(20, 300, 1500, 3, **KNOBS)
    twin.write_bal(t, str(tmp_path / "a.txt"), order_seed=5)
    twin.write_bal(t, str(tmp_path / "b.txt"), order_seed=6)
    twin.write_bal(t, str(tmp_path / "c.txt"), order_seed=5)
    a, b = (tmp_path / "a.txt").read_bytes(), (tmp_path / "b.txt").read_bytes()
    assert a != b and a == (tmp_path / "c.txt").read_bytes()
    pa, pb = load_bal(str(tmp_path / "a.txt"), True), load_bal(
        str(tmp_path / "b.txt"), True)
    for k in ("obs_lm", "obs_cam", "obs_uv", "lm_p", "cam_q", "cam_t"):
        assert np.array_equal(getattr(pa, k), getattr(pb, k)), k
    assert np.array_equal(pa.obs_uv, t["obs_uv"])

"""The generator's arithmetic against a NumPy twin on the same draws."""

import numpy as np
import torch

from benchlib import data

CFG = {"m": 60, "n": 300, "support_frac": 0.05, "noise_std": 0.01,
       "lam1_frac": 0.1}


def twin(d: data.Draws, cfg: dict):
    G = d.G.numpy().astype(np.float64)
    A = G.T / np.linalg.norm(G.T, axis=0, keepdims=True)
    nnz = int(round(cfg["support_frac"] * cfg["n"]))
    idx = d.perm.numpy()[:nnz]
    z = d.z.numpy()[:nnz].astype(np.float64)
    x = np.zeros(cfg["n"])
    x[idx] = z + np.sign(z)
    b = A @ x + cfg["noise_std"] * d.noise.numpy()
    lam_max = np.abs(A.T @ b).max()
    return A, b, idx, lam_max


def test_generator_matches_numpy_twin():
    d = data.draw(7, CFG["m"], CFG["n"], "cpu")
    A, b, idx, lam_max = twin(data.Draws(G=d.G.clone(), perm=d.perm,
                                         z=d.z, noise=d.noise), CFG)
    inst = data.assemble(d, CFG)
    np.testing.assert_allclose(inst.A.numpy(), A, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(inst.b.numpy(), b, rtol=1e-4, atol=1e-5)
    assert sorted(inst.support.tolist()) == sorted(idx.tolist())
    assert inst.support.numel() == 15
    assert abs(inst.lam_max - lam_max) <= 1e-5 * lam_max
    assert inst.lam1 == CFG["lam1_frac"] * inst.lam_max
    assert inst.A.shape == (60, 300) and inst.A_rows.is_contiguous()
    assert float(inst.x_true.abs().min()) >= 1.0


def test_same_seed_same_data_and_large_seeds():
    s = data.instance_seed(2**33 + 12345)
    assert 0 <= s < 2**63 and s != data.instance_seed(2**33 + 12346)
    a = data.make_instance(s, CFG, "cpu")
    b = data.make_instance(s, CFG, "cpu")
    assert torch.equal(a.A_rows, b.A_rows) and torch.equal(a.b, b.b)
    c = data.make_instance(data.instance_seed(5), CFG, "cpu")
    assert not torch.equal(a.A_rows, c.A_rows)

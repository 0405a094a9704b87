"""The port's SOAP (coolchic_tpu_torch/train/soap.py) against the JAX
package's (coolchic_tpu/train/soap.py) under a fixed gradient sequence made
from a seed: the eigh seeding from the first gradient (seed_opt_state's
per-leaf step), then twelve steps with the QR eigenbasis refresh on the
tenth, for the leaf shapes the trainer meets (ARM [out, in], synthesis
[out, in, k, k], 1-D biases, and a latent grid under the plain-Adam
hyper-parameters). The port runs two images as one batch; JAX runs each
alone.

Tolerance: parameters, exp_avg and exp_avg_sq within 2e-6 absolute plus
1e-6 relative after every step (values of order 1 to 100, lr 1e-2; the
projections sum in another order). Q is compared through what it does
(the update), not entry by entry: a QR may flip a column's sign and the
update does not change. The refresh comes once every GG has full rank (a
48 x 7 leaf needs 7 gradients or more): the null-space basis of a
rank-deficient GG is rounding noise in either package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.train import soap as js
from coolchic_tpu_torch.train import soap as ps

torch.set_num_threads(2)
N_STEPS, PF, LR = 12, 10, 1e-2
HP_WEIGHT = dict(b1=0.95, b2=0.95, weight_decay=0.01, precondition_frequency=PF,
                 max_precond_dim=256)
HP_LATENT = dict(b1=0.9, b2=0.999, weight_decay=0.0, precondition_frequency=1,
                 max_precond_dim=0)
CASES = {"arm_last": ((2, 7), HP_WEIGHT), "arm_hidden": ((14, 14), HP_WEIGHT),
         "syn_1x1": ((48, 7, 1, 1), HP_WEIGHT), "syn_3x3": ((3, 3, 3, 3), HP_WEIGHT),
         "bias": ((14,), HP_WEIGHT), "latent": ((16, 24), HP_LATENT)}


@pytest.mark.parametrize("case", list(CASES))
def test_soap_sequence(case):
    shape, hpd = CASES[case]
    hp_j, hp_p = js.SoapHyperParams(**hpd), ps.SoapHyperParams(**hpd)
    rng = np.random.default_rng(sum(map(ord, case)))
    G = 2
    p0 = rng.normal(0, 1, (G, *shape)).astype(np.float32)
    grads = rng.normal(0, 1, (N_STEPS + 1, G, *shape)).astype(np.float32)
    # a decaying trend makes the covariance anisotropic, so the sort in the
    # QR refresh has work to do
    grads += np.linspace(3, 0, N_STEPS + 1, dtype=np.float32).reshape(-1, 1, *[1] * len(shape)) \
        * rng.normal(0, 1, (1, G, *shape)).astype(np.float32)

    # JAX, image by image
    ref = []
    for g in range(G):
        param = jnp.asarray(p0[g])
        st = js.soap_init_from_grad_leaf(grads[0, g], js.soap_init_leaf(param, hp_j), hp_j)
        traj = []
        for t in range(1, N_STEPS + 1):
            param, st = js.soap_step_leaf(jnp.asarray(grads[t, g]), st, param, LR, hp_j,
                                          refresh=t % PF == 0)
            traj.append((np.asarray(param), np.asarray(st["exp_avg_sq"]),
                         np.asarray(st["exp_avg"])))
        ref.append(traj)

    # the port, both images as one batch
    param = torch.tensor(p0)
    lr = torch.tensor(LR, dtype=torch.float32)
    st = ps.soap_init_from_grad_leaf(torch.tensor(grads[0]), ps.soap_init_leaf(param, hp_p),
                                     hp_p)
    for t in range(1, N_STEPS + 1):
        param, st = ps.soap_step_leaf(torch.tensor(grads[t]), st, param, lr, hp_p,
                                      refresh=t % PF == 0)
        assert st["step"].tolist() == [t] * G
        for g in range(G):
            j_param, j_sq, j_avg = ref[g][t - 1]
            np.testing.assert_allclose(param[g].numpy(), j_param, rtol=1e-6, atol=2e-6,
                                       err_msg=f"{case} step {t} image {g}")
            # exp_avg / exp_avg_sq live in the eigenbasis: sign flips of Q's
            # columns flip exp_avg's coordinates, never exp_avg_sq's
            np.testing.assert_allclose(st["exp_avg_sq"][g].numpy(), j_sq, rtol=1e-6,
                                       atol=2e-6)
            np.testing.assert_allclose(np.abs(st["exp_avg"][g].numpy()), np.abs(j_avg),
                                       rtol=1e-6, atol=2e-6)

"""Gradients through the port's REFERENCE-convention edge path against
``jax.grad`` of the JAX package's, on the loss the trainer takes
(``multi_iteration_loss`` under the REFERENCE decision), atol 1e-6 / rtol
1e-4.  The channel sits on the QMS grid, so the check updates meet tied
minima and the clips their bounds all the time (``ops/ties.py``).  The codes
are lifted at Z = 8 to keep JAX's compile short."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.structs import Convention as JaxConvention
from neural_ldpc_tpu.training.loss import multi_iteration_loss as jax_loss
from neural_ldpc_tpu_torch.structs import Convention
from neural_ldpc_tpu_torch.training import multi_iteration_loss
from test_torch_edge import BG2, WMAN, boosted_pair
from test_torch_grad import GRAD_TOL


@pytest.mark.parametrize("code_name,z,decoder_type,sharing,n_iter", [
    (BG2, 8, "QMS", dict(cn=3, vn=3), 3),
    (BG2, 8, "QMS", dict(cn=3, ucn=2), 3),
    (WMAN, 8, "MS", dict(cn=3, ucn=2), 3),
])
def test_reference_edge_grads_match_jax(code_name, z, decoder_type, sharing, n_iter):
    dec, jdec = boosted_pair(code_name, decoder_type, sharing, n_iter, "reference", z=z)
    rng = np.random.default_rng(11)
    params = {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in jdec.init_params().items()}
    g, sigma, batch = dec.graph, 0.7, 8
    bits = np.zeros((batch, g.N * g.Z), np.float32)
    # REFERENCE: bit 0 -> -1
    llr = (2 * (-1.0 + sigma * rng.standard_normal((batch, g.N, g.Z))) / sigma**2)
    llr = llr.astype(np.float32)
    if decoder_type == "QMS":
        llr = np.round(llr * 2) / 2  # channel values on the grid: ties everywhere
    coeff = list(range(n_iter))
    ref = Convention.REFERENCE

    def jloss(p, x):
        return jax_loss(jdec.apply(p, x), jnp.asarray(bits), coeff=coeff,
                        convention=JaxConvention.REFERENCE)

    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(llr))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    x = torch.tensor(llr, requires_grad=True)
    loss = multi_iteration_loss(dec.apply(p, x), torch.tensor(bits), coeff=coeff, convention=ref)
    grads = torch.autograd.grad(loss, [*p.values(), x])
    assert abs(float(loss.detach()) - float(jval)) < 1e-6
    for k, gk in zip(p, grads):
        np.testing.assert_allclose(gk.numpy(), np.asarray(jgp[k]), err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), err_msg="llr", **GRAD_TOL)

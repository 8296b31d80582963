"""K3's plain version against the encoder microbenchmark's chain.

``tools/microbench_encoder.py`` nests its functions in ``main()``, so the
test copies two of them (nothing in ``tools/`` changes): ``chain``, a
``lax.scan`` of bf16 dots with f32 accumulation (``:68-72``), and
``fused_kernel`` / ``call``, the Pallas prototype (``:127-166``), run here in
interpret mode. Inputs are seeded numpy at T = 16, D = 128.

Tolerance: each product accumulates in f32 and rounds to bf16; the port and
XLA sum the f32 terms in other orders. At k = 1 an element can therefore
differ by one bf16 ulp plus the f32 order bound 2·D·2^-24·(|x| @ |W|). Along
a chain one flipped rounding feeds every element of the next product, so
for k > 1 both are held against the exact chain (f32 products, no
intermediate rounding): the plain version's rms and max error must be
within 1.25x of the JAX chain's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from realtime_whisper_asr_tpu_torch.ops import matmul_chain as K3

torch.set_num_threads(2)

T, D = 16, 128


def chain(x, wstack):
    """tools/microbench_encoder.py:68-72."""
    def body(h, wk):
        return jnp.dot(h, wk, preferred_element_type=jnp.float32).astype(h.dtype), None
    h, _ = jax.lax.scan(body, x, wstack)
    return h


def fused_kernel(w_ref, x_ref, o_ref, acc):
    """tools/microbench_encoder.py:127-142."""
    k = pl.program_id(0)

    @pl.when(k == 0)
    def _():
        acc[:] = x_ref[:]

    acc[:] = jnp.dot(acc[:], w_ref[0], preferred_element_type=jnp.float32).astype(acc.dtype)

    @pl.when(k == pl.num_programs(0) - 1)
    def _():
        o_ref[:] = acc[:]


def call(x, ws, k):
    """tools/microbench_encoder.py:147-166, with ``interpret=True``."""
    return pl.pallas_call(
        fused_kernel,
        grid=(k,),
        in_specs=[
            pl.BlockSpec((1, D, D), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((T, D), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((T, D), lambda i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((T, D), x.dtype),
        scratch_shapes=[pltpu.VMEM((T, D), x.dtype)],
        interpret=True,
    )(ws, x)


def _inputs(k: int):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jws = jnp.stack([jnp.asarray(w, jnp.bfloat16)] * k)  # the tool's chain: one weight k times
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).bfloat16()
    tws = torch.from_numpy(np.asarray(jws.astype(jnp.float32))).bfloat16()
    return jx, jws, tx, tws


def _check(ours: torch.Tensor, ref, tx: torch.Tensor, tws: torch.Tensor) -> None:
    ours = ours.float()
    ref = torch.from_numpy(np.asarray(jnp.asarray(ref, jnp.float32)))
    assert ours.shape == ref.shape == (T, D)
    k = tws.shape[0]
    if k == 1:
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
        tol = ulp + 2 * D * 2.0 ** -24 * (tx.float().abs() @ tws[0].float().abs())
        assert bool(((ours - ref).abs() <= tol).all())
        return
    exact = tx.float()
    for w in tws:
        exact = exact @ w.float()
    e_o, e_r = ours - exact, ref - exact
    assert float(e_o.square().mean().sqrt()) <= 1.25 * float(e_r.square().mean().sqrt())
    assert float(e_o.abs().max()) <= 1.25 * float(e_r.abs().max())


@pytest.mark.parametrize("k", [1, 3, 8])
def test_plain_matches_the_tools_scan_chain(k):
    jx, jws, tx, tws = _inputs(k)
    _check(K3.matmul_chain(tx, tws), chain(jx, jws), tx, tws)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_plain_matches_the_tools_pallas_chain_in_interpret_mode(k):
    jx, jws, tx, tws = _inputs(k)
    ref = call(jx, jws, k)
    np.testing.assert_array_equal(np.asarray(ref, np.float32),
                                  np.asarray(chain(jx, jws), np.float32))
    _check(K3.matmul_chain(tx, tws), ref, tx, tws)


def test_wrapper_checks_its_inputs():
    _, _, tx, tws = _inputs(2)
    with pytest.raises(TypeError):
        K3.matmul_chain(tx.float(), tws)
    with pytest.raises(ValueError, match="takes x"):
        K3.matmul_chain(tx, tws[:, :64])
    with pytest.raises(ValueError, match="cuda or cpu"):
        K3.matmul_chain(tx.to("meta"), tws.to("meta"))
    assert K3.chain_launches == 0  # the CPU path never counts a launch


def test_kernel_path_raises_without_a_card():
    """The kernel path launches or raises: on a host without a card it never
    falls back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the kernel path")
    _, _, tx, tws = _inputs(2)
    with pytest.raises(Exception):
        K3._matmul_chain_kernel(tx, tws)
    assert K3.chain_launches == 0

"""``ServingEngine`` on port Programs gives the same greedy streams as the
reference engine on the JAX Program."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

import mpk
from repro.configs import get_config
from repro.models import init_params as jax_init_params
from repro.runtime import Request as RefRequest
from repro.runtime import ServingEngine as RefEngine
from repro_torch.api import compile as torch_compile
from repro_torch.models import params_from_jax
from repro_torch.runtime import Request, ServingEngine


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab, size=n).tolist() for n in (5, 9, 3)]


@pytest.mark.parametrize("backend", ["torch", "megakernel"])
def test_engine_streams_match_reference(backend):
    cfg = get_config("deepseek-7b").reduced()
    jp = jax_init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    prompts = _prompts(cfg)

    ref_eng = RefEngine(mpk.compile(cfg, 2, 32, backend="jax").bind(jp),
                        chunk=8)
    for i, p in enumerate(prompts):
        ref_eng.submit(RefRequest(i, p, max_new_tokens=4))
    ref = {r.request_id: r.output for r in ref_eng.run()}

    prog = torch_compile(cfg, 2, 32, backend=backend, device="cpu")
    prog.bind(params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                              device="cpu"))
    eng = ServingEngine(prog, chunk=8)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=4))
    got = {r.request_id: r.output for r in eng.run()}
    assert got == ref
    assert eng.decode_iterations > 0      # decode went through step()
    if backend == "megakernel":
        assert prog.upload_count == 1
        assert prog.executor.state_scatter_count > 0
    snap = eng.metrics_snapshot()
    assert snap["program"]["backend"] == backend

from .lm import (block_structure, init_cache, init_params, params_from_jax,
                 prefill_chunk, serve_step)

__all__ = ["block_structure", "init_cache", "init_params", "params_from_jax",
           "prefill_chunk", "serve_step"]

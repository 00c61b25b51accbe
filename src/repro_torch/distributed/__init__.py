"""Tensor parallelism: the chunked ring-allreduce planner that the
multichip stamp (``megakernel/desc.stamp_multichip``) and the ``mpk_tp``
simulator (``core/runtime_sim``) both consume."""
from .comm_tasks import (MODE_ACC, MODE_INIT, MODE_STORE, CommTask,
                         expand_ring_allreduce, n_comm_events, n_ring_steps,
                         ref_ring_allreduce, ring_chunks, ring_duration,
                         send_rounds, serialized_duration)

__all__ = ["CommTask", "MODE_INIT", "MODE_ACC", "MODE_STORE",
           "n_ring_steps", "n_comm_events", "ring_chunks",
           "expand_ring_allreduce", "send_rounds", "ring_duration",
           "serialized_duration", "ref_ring_allreduce"]

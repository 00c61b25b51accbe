from .desc import (DESC_WORDS, KIND_CODES, PER_STEP_INPUTS, STATS_WORDS,
                   MegakernelPlan, lower_tgraph)
from .kernel import (launch_count, megakernel, megakernel_plain,
                     reset_launch_count)
from .ops import MegakernelExecutor, compile_decode_megakernel

__all__ = ["DESC_WORDS", "KIND_CODES", "PER_STEP_INPUTS", "STATS_WORDS",
           "MegakernelPlan", "lower_tgraph", "launch_count", "megakernel",
           "megakernel_plain", "reset_launch_count", "MegakernelExecutor",
           "compile_decode_megakernel"]

from .engine import decode_loop, decode_step, generate, init_cache, prefill
from .optimize import fuse_for_serving

__all__ = ["decode_loop", "decode_step", "fuse_for_serving", "generate", "init_cache",
           "prefill"]

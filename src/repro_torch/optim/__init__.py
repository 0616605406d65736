from .adamw import AdamWConfig, apply_updates, global_norm, init_state
from .compression import compress_tree, compressed_bytes
from .schedule import cosine_with_warmup

from .mesh import (
    activate,
    current_mesh,
    deactivate,
    maybe_init_distributed,
    sessions_mesh,
    shard_flat,
    shard_leading,
    use_mesh,
)

__all__ = [
    "activate",
    "current_mesh",
    "deactivate",
    "maybe_init_distributed",
    "sessions_mesh",
    "shard_flat",
    "shard_leading",
    "use_mesh",
]

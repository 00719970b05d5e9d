from kwok_tpu_torch.cluster.store import (  # noqa: F401
    ADDED,
    DELETED,
    MODIFIED,
    SYNC,
    Conflict,
    Expired,
    NotFound,
    ResourceStore,
    ResourceType,
    WatchEvent,
    Watcher,
)

"""Snapshots of engine state and their re-layout across shard counts."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, pack_json,
                                                 restore_into, unpack_json)
from repro_torch.checkpoint.elastic import (LayoutSpec, derive_shard_keys,
                                            pagerank_state_specs,
                                            relayout_arrays,
                                            relayout_pagerank_state,
                                            relayout_staged_flat)

__all__ = ["Checkpointer", "LayoutSpec", "derive_shard_keys", "pack_json",
           "pagerank_state_specs", "relayout_arrays",
           "relayout_pagerank_state", "relayout_staged_flat", "restore_into",
           "unpack_json"]

from repro_torch.checkpoint.checkpointer import (Checkpointer,  # noqa
                                                 latest_step, pack_tree,
                                                 reshard_tree, unpack_tree)

from islam_tpu_torch.parallel.mesh import (make_mesh,
                                           multi_sequence_train_step,
                                           shard_batch)

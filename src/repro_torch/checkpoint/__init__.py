from repro_torch.checkpoint import ckpt, integrity
from repro_torch.checkpoint.ckpt import latest_step, raw_leaves, restore, save
from repro_torch.checkpoint.integrity import (CorruptCheckpointError,
                                              IntegrityError,
                                              NoVerifiedCheckpointError,
                                              RestoreInfo,
                                              latest_verified_step,
                                              quarantine, verified_raw_leaves,
                                              verified_restore,
                                              verify_step_dir)

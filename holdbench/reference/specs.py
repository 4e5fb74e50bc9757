"""Entity descriptors (a frozen copy of the port's
hold_tpu_torch/models/specs.py)."""

MANO_SPECS = {
    "pose_dim": 45,
    "full_pose_dim": 48,
    "shape_dim": 10,
    "num_full_tfs": 16,
    "num_tfs": 15,
    "total_dim": 62,
    "embedding": "fourier",
}

OBJECT_SPECS = {
    "pose_dim": 0,
    "full_pose_dim": 3,
    "num_full_tfs": 1,
    "num_tfs": 0,
    "total_dim": 7,
    "embedding": "barf",
}

BG_SPECS = {
    "pose_dim": 45,
    "full_pose_dim": 48,
    "shape_dim": 10,
    "num_full_tfs": 16,
    "num_tfs": 15,
    "total_dim": 62,
    "embedding": "fourier",
}

# semantic class ids (code/src/utils/const.py + node class ids)
SEGM_IDS = {"bg": 0, "object": 50, "right": 150, "left": 250}
CLASS_IDS = {"object": 1, "right": 2, "left": 3}
MAX_CLASS = 4
TIME_CODE_DIM = 32

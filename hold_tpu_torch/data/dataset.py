"""Sequence dataset: frames + cameras + weighted pixel sampling + tempo
batches + full-frame render batches (counterpart of hold_tpu/data/dataset.py).

Host-side numpy, with the JAX package's sampling semantics: 90% of a frame's
rays inside the hand/object mask bounding boxes (split evenly), 10% uniform,
bilinear interpolation of rgb and mask; a training batch is ``batch_size``
random (i, i+offset) frame pairs flattened to 2*batch_size frames.  The data
comes either from an in-memory build (``data.synthetic.generate_sequence``)
or from a build dir on disk (read with cv2, imported only then).
"""

from __future__ import annotations

import glob
import os

import numpy as np
from scipy.linalg import rq

from ..models.specs import SEGM_IDS


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a (3, 4) projection P = K [R | -R C] into intrinsics (4, 4)
    and the camera-to-world pose (4, 4), by an RQ decomposition whose K has a
    positive diagonal (the convention of cv2.decomposeProjectionMatrix)."""
    K, R = rq(P[:3, :3])
    D = np.diag(np.sign(np.diag(K)))
    K, R = K @ D, D @ R
    K = K / K[2, 2]
    center = -np.linalg.solve(P[:3, :3], P[:3, 3])
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = center
    return intrinsics.astype(np.float32), pose


class SequenceData:
    """Frames, masks, cameras and entity params of one sequence."""

    def __init__(self, images: np.ndarray, masks: np.ndarray, data: dict,
                 num_sample: int = 128):
        self.images = images  # (N, H, W, 3) uint8 RGB
        self.masks = masks  # (N, H, W) uint8 grey levels
        self.data = data
        self.num_sample = num_sample
        self.entities = data["entities"]
        self.scene_bounding_sphere = float(data.get("scene_bounding_sphere", 3.0))
        self.n_frames = images.shape[0]
        self.img_size = images.shape[1:3]

        cams = data["cameras"]
        intr, extr, scale_mats = [], [], []
        for i in range(self.n_frames):
            scale_mat = cams[f"scale_mat_{i}"].astype(np.float64)
            world_mat = cams[f"world_mat_{i}"].astype(np.float64)
            scale_mats.append(scale_mat)
            K, pose = load_K_Rt_from_P((world_mat @ scale_mat)[:3, :4])
            intr.append(K)
            extr.append(pose)
        self.intrinsics_all = np.stack(intr)
        self.extrinsics_all = np.stack(extr)
        self.scale = float(1.0 / scale_mats[0][0, 0])
        self.hand_ids = [k for k in ("right", "left") if k in self.entities]
        self.case = ""  # the sequence's name, for a sequence read from disk
        self.img_paths: list = []  # the frames' files, for a sequence read from disk
        self.mask_paths: list = []  # their masks' (None for each when it has none)

    @classmethod
    def from_build_dir(cls, case: str, data_root: str = "./data", num_sample: int = 128):
        """Read ``<data_root>/<case>/build/{image,mask}/*.png`` + data.npy."""
        import cv2

        root = os.path.join(data_root, case, "build")
        data = np.load(os.path.join(root, "data.npy"), allow_pickle=True).item()
        img_paths = sorted(glob.glob(os.path.join(root, "image", "*.png")))
        if not img_paths:
            raise FileNotFoundError(f"no images under {root}/image")
        mask_paths = sorted(glob.glob(os.path.join(root, "mask", "*.png")))
        images = np.stack([cv2.imread(p)[:, :, ::-1] for p in img_paths])
        if mask_paths:
            masks = np.stack([
                cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2GRAY) for p in mask_paths
            ])
        else:
            masks = np.zeros(images.shape[:3], np.uint8)
        seq = cls(images, masks, data, num_sample=num_sample)
        seq.case = case
        seq.img_paths = img_paths
        seq.mask_paths = mask_paths or [None] * len(img_paths)
        return seq

    def load_frame(self, idx: int):
        """(rgb (H,W,3) float32 in [0,1], mask (H,W) float32 grey levels)."""
        return (self.images[idx].astype(np.float32) / 255.0,
                self.masks[idx].astype(np.float32))

    def _bilinear(self, rows, cols, img):
        r0 = np.floor(rows).astype(np.int32)
        c0 = np.floor(cols).astype(np.int32)
        fr = (rows - r0)[:, None] if img.ndim == 3 else rows - r0
        fc = (cols - c0)[:, None] if img.ndim == 3 else cols - c0
        r1, c1 = r0 + 1, c0 + 1
        return (
            img[r0, c0] * (1 - fr) * (1 - fc)
            + img[r0, c1] * (1 - fr) * fc
            + img[r1, c0] * fr * (1 - fc)
            + img[r1, c1] * fr * fc
        )

    def weighted_pixel_sample(self, rng: np.random.RandomState, idx: int,
                              hand_flag: str, num_sample: int):
        """(rows, cols) float pixel coords biased to the entity bboxes."""
        mask = self.masks[idx].astype(np.float32)
        H, W = self.img_size
        n_bbox = int(num_sample * 0.9)
        n_o = n_bbox // 2
        n_h = n_bbox - n_o
        where_o = np.asarray(np.where(np.abs(mask - SEGM_IDS["object"]) < 25))
        where_h = np.asarray(np.where(np.abs(mask - SEGM_IDS[hand_flag]) < 25))
        if where_o.size < 20:
            n_o, n_h = 0, n_bbox
        if where_h.size < 20:
            n_o, n_h = (n_bbox, 0) if where_o.size >= 20 else (0, 0)
        chunks = []
        for n, where in ((n_o, where_o), (n_h, where_h)):
            if n > 0:
                lo, hi = where.min(axis=1), where.max(axis=1)
                chunks.append(rng.rand(n, 2) * (hi - lo) + lo)
        n_uniform = num_sample - sum(c.shape[0] for c in chunks)
        chunks.append(rng.rand(n_uniform, 2) * (np.array([H, W]) - 1))
        rc = np.concatenate(chunks, axis=0)
        rc[:, 0] = np.clip(rc[:, 0], 0, H - 2)
        rc[:, 1] = np.clip(rc[:, 1], 0, W - 2)
        return rc

    def sample_frame(self, rng: np.random.RandomState, idx: int,
                     num_sample: int | None = None):
        """One frame's rays: uv (P,2) as (x, y), gt_rgb (P,3), gt_mask (P,)."""
        num_sample = num_sample or self.num_sample
        img, mask = self.load_frame(idx)
        per_hand = num_sample // len(self.hand_ids)
        rc = np.concatenate(
            [self.weighted_pixel_sample(rng, idx, h, per_hand) for h in self.hand_ids], axis=0
        )
        rows, cols = rc[:, 0], rc[:, 1]
        return {
            "uv": np.stack([cols, rows], axis=1).astype(np.float32),
            "gt_rgb": self._bilinear(rows, cols, img).astype(np.float32),
            "gt_mask": self._bilinear(rows, cols, mask).astype(np.float32),
        }

    def sample_tempo_batch(self, rng: np.random.RandomState, batch_size: int,
                           offset: int = 1, num_sample: int | None = None):
        starts = rng.randint(0, max(self.n_frames - offset, 1), size=batch_size)
        frames = np.stack([starts, starts + offset], axis=1).reshape(-1)
        items = [self.sample_frame(rng, int(i), num_sample) for i in frames]
        return {
            "frame_idx": frames.astype(np.int32),
            "uv": np.stack([it["uv"] for it in items]),
            "gt_rgb": np.concatenate([it["gt_rgb"] for it in items]),
            "gt_mask": np.concatenate([it["gt_mask"] for it in items]),
            "intrinsics": self.intrinsics_all[frames],
            "extrinsics": self.extrinsics_all[frames],
            "scene_scale": np.float32(self.scale),
        }

    def full_frame_batch(self, idx: int, downsample: int = 1) -> dict:
        """All pixels of one frame, strided by ``downsample``, for full
        renders: uv (1, HW, 2) as (x, y), gt_rgb (HW, 3), gt_mask (HW,),
        the frame's cameras and ``img_hw``."""
        H, W = self.img_size
        ys, xs = np.mgrid[0:H:downsample, 0:W:downsample]
        uv = np.stack([xs, ys], axis=-1).reshape(1, -1, 2).astype(np.float32)
        img, mask = self.load_frame(idx)
        return {
            "frame_idx": np.asarray([idx], np.int32),
            "uv": uv,
            "gt_rgb": img[::downsample, ::downsample].reshape(-1, 3).astype(np.float32),
            "gt_mask": mask[::downsample, ::downsample].reshape(-1).astype(np.float32),
            "intrinsics": self.intrinsics_all[idx][None],
            "extrinsics": self.extrinsics_all[idx][None],
            "scene_scale": np.float32(self.scale),
            "img_hw": (ys.shape[0], ys.shape[1]),
        }

    def scene_data(self) -> dict:
        return {
            "entities": self.entities,
            "scale": self.scale,
            "n_frames": self.n_frames,
            "scene_bounding_sphere": self.scene_bounding_sphere,
        }


def test_frame_split(n_frames: int, num_agents: int, agent_id: int) -> list[int]:
    """The frames of one of ``num_agents`` render jobs (contiguous chunks)."""
    return np.array_split(np.arange(n_frames), num_agents)[agent_id].tolist()

"""The codebook: SO(3) view embeddings, nearest rotation, 6D pose recovery
(port of augmentedautoencoder_tpu/codebook.py).

Rows are l2-normalized latent codes in viewsphere order (row i ->
viewsphere[i]), built by `Codebook.build_embedding`, which streams rendered
view batches through the encoder on the device. Queries run on the
codebook's device: the top-1 through
`ops.cosine_top1` (the CUDA kernel on a GPU), ranked top-k with `upright`
stride or TTA means through the plain `ops.cosine_topk`. The pose math
(projective translation, off-center rotation correction, candidate
aggregation) is the JAX package's numpy code, unchanged.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .geometry.transform import matrices_from_quaternions, quaternions_from_matrices
from .ops._cuda import stream_width
from .ops.nn_query import cosine_top1, cosine_topk, l2_normalize, pad_columns
from .parallel.distributed import all_gather_rows
from .parallel.mesh import DATA_AXIS, axis_index, axis_size
from .utils import batch_iteration_indices

EncodeFn = Callable[[torch.Tensor], torch.Tensor]  # (B,H,W,C) float in [0,1] -> (B, latent)


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 image batch -> float32 in [0, 1] on x's device."""
    return x.to(torch.float32) / 255.0


@contextlib.contextmanager
def f32_without_tf32():
    """cuDNN convolutions and matmuls in full f32 inside the block (cuDNN
    defaults to TF32 for f32 convolutions); the previous flags come back
    after it."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def _gather_runs(codes: torch.Tensor, bbs: np.ndarray, rows, mesh) -> Tuple[torch.Tensor, np.ndarray]:
    """Every rank's (codes, boxes) of its run of views, `rows[r]` rows on
    rank r, stacked in rank (so view) order over the mesh's data axis:
    the runs padded to the longest for one all-gather each."""
    group, longest = mesh.get_group(DATA_AXIS), max(rows)

    def gather(t: torch.Tensor) -> torch.Tensor:
        pad = torch.zeros((longest - t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        out = all_gather_rows(torch.cat([t, pad]), group).view((len(rows), longest) + tuple(t.shape[1:]))
        return torch.cat([out[r, :n] for r, n in enumerate(rows)])

    boxes = gather(torch.from_numpy(np.ascontiguousarray(bbs)).to(codes.device))
    return gather(codes), boxes.cpu().numpy()


# Deterministic multi-crop TTA pattern (relative bbox-center offsets);
# entry 0 is the detection itself.
_TTA_OFFSETS = (
    (0.0, 0.0),
    (0.10, 0.0), (-0.10, 0.0), (0.0, 0.10), (0.0, -0.10),
    (0.07, 0.07), (-0.07, -0.07), (0.07, -0.07), (-0.07, 0.07),
    (0.15, 0.0), (-0.15, 0.0), (0.0, 0.15), (0.0, -0.15),
    (0.11, 0.11), (-0.11, -0.11), (0.11, -0.11),
)


def tta_jittered_bboxes(bb_xywh: Sequence[float], n: int) -> np.ndarray:
    """`n` deterministically jittered copies of an xywh bbox (first = the
    original), detection-major for `auto_pose6d_batch(..., tta=n)`."""
    if n > len(_TTA_OFFSETS):
        raise ValueError(f"tta_crops max is {len(_TTA_OFFSETS)}, got {n}")
    x, y, w, h = (float(v) for v in bb_xywh)
    return np.array([[x + dx * w, y + dy * h, w, h] for dx, dy in _TTA_OFFSETS[:n]])


def aggregate_candidates(
    viewsphere: np.ndarray,
    embed_obj_bbs: np.ndarray,
    part: np.ndarray,
    sims: np.ndarray,
    agg_angle_deg: float = 20.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Blend ranked top-k candidates (B, k) into one pose per row: keep the
    candidates within `agg_angle_deg` of the row's top-1 rotation and blend
    their quaternions and rendered boxes with similarity-proportional
    weights. Returns (Rs (B,3,3), rendered_bbs (B,4), top1 idcs (B,))."""
    part = np.asarray(part)
    sims = np.asarray(sims)
    top1 = part[:, 0]

    quats = quaternions_from_matrices(viewsphere[part])  # (B,k,4)
    dots = np.sum(quats * quats[:, :1], axis=-1)
    quats = np.where(dots[..., None] < 0, -quats, quats)
    inlier = np.abs(dots) >= np.cos(np.radians(agg_angle_deg) / 2.0)
    w = (sims - sims[:, -1:] + 1e-9) * inlier
    w /= w.sum(axis=1, keepdims=True)

    q_mean = (quats * w[..., None]).sum(axis=1)
    Rs = matrices_from_quaternions(q_mean)
    rbbs = np.asarray(embed_obj_bbs[part], dtype=np.float64)
    rendered_bbs = (rbbs * w[..., None]).sum(axis=1)
    return Rs, rendered_bbs, top1


class Codebook:
    """A per-object codebook bound to an encoder, resident on `device`
    (default: the GPU; `factory.default_device` raises without CUDA)."""

    def __init__(
        self,
        encode_fn: EncodeFn,
        viewsphere: np.ndarray,  # (N, 3, 3)
        embedding_normalized=None,  # (N, latent)
        embed_obj_bbs: Optional[np.ndarray] = None,  # (N, 4)
        num_cyclo: int = 36,
        device: Optional[Union[str, torch.device]] = None,
    ):
        from .factory import default_device  # factory imports this module

        self._encode = encode_fn
        self.device = torch.device(device) if device is not None else default_device()
        self.viewsphere = np.asarray(viewsphere)
        self.num_cyclo = int(num_cyclo)
        self.embedding_normalized = (
            torch.as_tensor(embedding_normalized, dtype=torch.float32).to(self.device)
            if embedding_normalized is not None
            else None
        )
        # the top-1 kernel's operand: the same rows with zero columns up to
        # the width it takes (the embedding itself when it has that width);
        # the plain top-k queries use the embedding as it is
        self._top1_operand = (
            pad_columns(self.embedding_normalized,
                        stream_width(self.embedding_normalized.shape[-1], torch.float32))
            if self.embedding_normalized is not None
            else None
        )
        self.embed_obj_bbs = (
            np.asarray(embed_obj_bbs) if embed_obj_bbs is not None else None
        )

    # ------------------------------------------------------------- build
    @staticmethod
    def build_embedding(
        encode_fn: EncodeFn,
        render_batch_fn: Callable[[int, int], Tuple[np.ndarray, np.ndarray]],
        embedding_size: int,
        batch_size: int = 256,
        progress: bool = True,
        device: Optional[Union[str, torch.device]] = None,
        profile: Optional[Dict[str, float]] = None,
        mesh=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Stream rendered view batches through the encoder on `device` (the
        GPU unless given "cpu"); returns (embedding_normalized (N, latent)
        f32, obj_bbs (N, 4)).

        Batch i + 1 renders on a worker thread while batch i goes to the
        device: uint8 through one pinned host buffer (non-blocking copy; the
        buffer is refilled only after the copy that read it has run), the
        ragged tail padded with zeros to the batch shape, normalized and
        encoded in f32 without TF32. The codes stay on the device until the
        last batch and are read back once; rows are normalized in f32 on the
        host, as the JAX package does. `profile`, if given, receives seconds:
        render (summed on the render thread), wait (host blocked on the next
        batch), h2d and encode (device, CUDA events; 0 on the CPU), readback
        and total.

        With a mesh, each rank of its data axis renders and encodes its own
        contiguous run of the batches (its own render thread, pinned buffer
        and batches: the build is bound by the host render), and the codes
        and boxes are gathered in view order before the readback (`gather`
        in `profile`, seconds). The batches are the one-process build's, so
        are the rows; every rank returns them."""
        from .factory import default_device  # factory imports this module

        device = torch.device(device) if device is not None else default_device()
        spans = list(batch_iteration_indices(embedding_size, batch_size))
        if not spans:
            raise ValueError(
                f"embedding_size={embedding_size} yields no view batches — "
                "check MIN_N_VIEWS/NUM_CYCLO in the [Embedding] config"
            )
        cuda = device.type == "cuda"
        times = {"render": 0.0, "wait": 0.0, "h2d": 0.0, "encode": 0.0, "readback": 0.0}
        t_start = time.perf_counter()
        runs = [spans]
        if mesh is not None:
            # rank r takes the r-th contiguous run of batches: [spans of 0, ..., spans of W-1]
            w = axis_size(mesh, DATA_AXIS)
            if len(spans) < w:
                raise ValueError(f"{len(spans)} view batches do not spread over {w} data ranks")
            runs = [[spans[i] for i in part] for part in np.array_split(np.arange(len(spans)), w)]
            spans = runs[axis_index(mesh, DATA_AXIS)]
        first = spans[0][0]

        def render(a, e):
            t0 = time.perf_counter()
            out = render_batch_fn(a, e)
            times["render"] += time.perf_counter() - t0  # one render thread
            return out

        host = codes = copied = None
        events = []  # (before copy, after copy, after encode) per batch, read at the end
        bb_chunks = []
        with f32_without_tf32(), torch.inference_mode(), ThreadPoolExecutor(1) as pool:
            pending = pool.submit(render, *spans[0])
            for i, (a, e) in enumerate(spans):
                if progress and a % (batch_size * 16) == 0:
                    print(f"embedding {a}/{embedding_size}")
                t0 = time.perf_counter()
                batch, obj_bbs = pending.result()
                times["wait"] += time.perf_counter() - t0
                if i + 1 < len(spans):
                    pending = pool.submit(render, *spans[i + 1])
                x = np.asarray(batch)
                if x.dtype != np.uint8:
                    x = x.astype(np.float32)
                if host is None:
                    dtype = torch.uint8 if x.dtype == np.uint8 else torch.float32
                    host = torch.zeros((batch_size,) + x.shape[1:], dtype=dtype, pin_memory=cuda)
                if copied is not None:
                    copied.synchronize()  # the previous copy has read the buffer
                host[: e - a] = torch.from_numpy(x)
                host[e - a:] = 0  # the ragged tail padded to the batch shape
                if cuda:
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                    ev[0].record()
                xd = host.to(device, non_blocking=True)
                if cuda:
                    ev[1].record()
                    copied = ev[1]
                    events.append(ev)
                z = encode_fn(xd)
                if cuda:
                    ev[2].record()
                if codes is None:
                    codes = torch.empty((spans[-1][1] - first, z.shape[1]), dtype=torch.float32, device=device)
                codes[a - first:e - first] = z[: e - a]
                bb_chunks.append(np.asarray(obj_bbs))
        bbs = np.concatenate(bb_chunks)
        if mesh is not None:
            t0 = time.perf_counter()
            codes, bbs = _gather_runs(codes, bbs, [run[-1][1] - run[0][0] for run in runs], mesh)
            times["gather"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        z_all = codes.cpu().numpy()
        times["readback"] = time.perf_counter() - t0
        for ev in events:
            times["h2d"] += ev[0].elapsed_time(ev[1]) / 1e3
            times["encode"] += ev[1].elapsed_time(ev[2]) / 1e3
        z_all /= np.linalg.norm(z_all, axis=1, keepdims=True)
        times["total"] = time.perf_counter() - t_start
        if profile is not None:
            profile.update(times, batches=len(spans), views=embedding_size)
        return z_all.astype(np.float32), bbs

    # ------------------------------------------------------------- queries
    def _require_embedding(self):
        if self.embedding_normalized is None:
            raise RuntimeError(
                "codebook embedding missing — run ae_embed for this experiment"
            )

    def _prep(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if x.dim() == 3:
            x = x[None]
        x = x.to(self.device)
        if x.dtype == torch.uint8:
            return normalize_uint8(x)
        return x.to(torch.float32)

    @torch.inference_mode()
    def nearest_rotation(self, x, top_n: int = 1, upright: bool = False, return_idcs: bool = False):
        """Nearest codebook rotation(s) for crop(s) x.

        Single crop (H,W,C): returns (3,3) [top_n=1] or (top_n,3,3).
        Batch (B,H,W,C): top_n must be 1; returns (B,3,3)."""
        self._require_embedding()
        z = self._encode(self._prep(x))

        # reference precedence: upright applies only at top_n == 1; top_n > 1
        # returns the ranked matches with upright ignored
        if top_n == 1 and not upright:
            _, idcs = cosine_top1(z, self._top1_operand)
            idcs = idcs.cpu().numpy()
        elif top_n == 1:
            _, idcs = cosine_topk(z, self.embedding_normalized, k=1, stride=self.num_cyclo)
            idcs = idcs.cpu().numpy()[:, 0]
        else:
            _, idcs = cosine_topk(z, self.embedding_normalized, k=self._clamp_k(top_n, 1))
            idcs = idcs.cpu().numpy().squeeze(0)

        if return_idcs:
            return idcs
        return self.viewsphere[idcs].squeeze()

    @torch.inference_mode()
    def nearest_rotation_batch(self, x) -> np.ndarray:
        self._require_embedding()
        z = self._encode(self._prep(x))
        _, idcs = cosine_top1(z, self._top1_operand)
        return self.viewsphere[idcs.cpu().numpy()]

    @torch.inference_mode()
    def test_embedding(self, x, normalized: bool = True) -> np.ndarray:
        z = self._encode(self._prep(x))
        if normalized:
            z = l2_normalize(z)
        return z.cpu().numpy().squeeze()

    # ------------------------------------------------------------- 6D pose
    def auto_pose6d(
        self,
        x,
        predicted_bb: Sequence[float],
        K_test: np.ndarray,
        top_n: int,
        train_cfg,
        depth_pred: Optional[float] = None,
        upright: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Full 6D estimate for one crop: (Rs_est (top_n,3,3), ts_est (top_n,3))."""
        self._require_embedding()
        if self.embed_obj_bbs is None:
            raise RuntimeError("codebook has no embedded bboxes (EMBED_BB off)")
        idcs = np.atleast_1d(
            self.nearest_rotation(x, top_n=top_n, upright=upright, return_idcs=True)
        )
        Rs_est = self.viewsphere[idcs].copy()

        K_train = train_cfg.K
        render_radius = train_cfg.radius
        K_test = np.asarray(K_test, dtype=np.float64)

        K_diag_ratio = np.sqrt(K_test[0, 0] ** 2 + K_test[1, 1] ** 2) / np.sqrt(
            K_train[0, 0] ** 2 + K_train[1, 1] ** 2
        )

        predicted_bb = np.asarray(predicted_bb, dtype=np.float64)
        ts_est = np.empty((len(idcs), 3))
        for i, idx in enumerate(idcs):
            rendered_bb = np.asarray(self.embed_obj_bbs[idx]).squeeze()
            if depth_pred is None:
                bb_diag_ratio = np.linalg.norm(
                    np.float32(rendered_bb[2:])
                ) / np.linalg.norm(np.float32(predicted_bb[2:]))
                z = bb_diag_ratio * K_diag_ratio * render_radius
            else:
                z = depth_pred

            cx_train = rendered_bb[0] + rendered_bb[2] / 2.0 - K_train[0, 2]
            cy_train = rendered_bb[1] + rendered_bb[3] / 2.0 - K_train[1, 2]
            cx_test = predicted_bb[0] + predicted_bb[2] / 2.0 - K_test[0, 2]
            cy_test = predicted_bb[1] + predicted_bb[3] / 2.0 - K_test[1, 2]

            tx = cx_test * z / K_test[0, 0] - cx_train * render_radius / K_train[0, 0]
            ty = cy_test * z / K_test[1, 1] - cy_train * render_radius / K_train[1, 1]
            t_est = np.array([tx, ty, z])
            ts_est[i] = t_est

            # the codebook holds CENTERED views; rotate so appearance is
            # preserved at the off-center crop location
            d_alpha_y = np.arctan(t_est[0] / np.sqrt(t_est[2] ** 2 + t_est[1] ** 2))
            d_alpha_x = -np.arctan(t_est[1] / t_est[2])
            ca, sa = np.cos(d_alpha_x), np.sin(d_alpha_x)
            cb, sb = np.cos(d_alpha_y), np.sin(d_alpha_y)
            R_corr_x = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
            R_corr_y = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
            Rs_est[i] = R_corr_y @ R_corr_x @ Rs_est[i]
        return Rs_est, ts_est

    def _clamp_k(self, k: int, stride: int) -> int:
        """k never exceeds the candidate count (strided width under `upright`)."""
        n = self.embedding_normalized.shape[0]
        width = n if stride <= 1 else -(-n // stride)
        return min(k, width)

    @torch.inference_mode()
    def topk_candidates(self, xs, k: int, upright: bool = False, tta: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k codebook indices + cosine similarities per detection
        (TTA rows averaged per detection first). Returns (idcs, sims)."""
        self._require_embedding()
        z = self._encode(self._prep(xs))
        stride = self.num_cyclo if upright else 1
        vals, idcs = cosine_topk(
            z,
            self.embedding_normalized,
            k=self._clamp_k(max(k, 1), stride),
            stride=stride,
            tta=tta,
        )
        return idcs.cpu().numpy(), vals.cpu().numpy()

    def pose6d_from_indices(
        self,
        idcs: np.ndarray,
        bbs: np.ndarray,
        K_test: np.ndarray,
        train_cfg,
        depth_pred: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Full 6D poses for GIVEN codebook indices. idcs (B,) gives one pose
        per detection; idcs (B,k) expands each detection into k hypotheses,
        returned flattened (B*k, ...)."""
        self._require_embedding()
        if self.embed_obj_bbs is None:
            raise RuntimeError("codebook has no embedded bboxes (EMBED_BB off)")
        idcs = np.asarray(idcs)
        bbs = np.asarray(bbs, dtype=np.float64)
        if idcs.ndim == 2:
            k = idcs.shape[1]
            bbs = np.repeat(bbs, k, axis=0)
            if depth_pred is not None:
                depth_pred = np.repeat(np.asarray(depth_pred, np.float64), k)
            idcs = idcs.reshape(-1)
        Rs = self.viewsphere[idcs].copy()
        rendered_bbs = np.asarray(self.embed_obj_bbs[idcs], dtype=np.float64)
        return self._solve_6d(Rs, rendered_bbs, bbs, K_test, train_cfg, depth_pred)

    @torch.inference_mode()
    def auto_pose6d_batch(
        self,
        xs,
        bbs: np.ndarray,
        K_test: np.ndarray,
        train_cfg,
        depth_pred: Optional[np.ndarray] = None,
        upright: bool = False,
        topk_aggregate: int = 1,
        tta: int = 1,
        agg_angle_deg: float = 20.0,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """6D poses for a batch of crops: one encode, one query, vectorized
        pose math. xs (B[*tta],H,W,C), bbs (B,4) xywh. Returns (Rs (B,3,3),
        ts (B,3), idcs (B,)). tta > 1 averages the cosine rows of `tta`
        jittered crops per detection; topk_aggregate > 1 blends the top-k
        matches (`aggregate_candidates`)."""
        self._require_embedding()
        if self.embed_obj_bbs is None:
            raise RuntimeError("codebook has no embedded bboxes (EMBED_BB off)")
        bbs = np.asarray(bbs, dtype=np.float64)
        xb = self._prep(xs)
        if tta > 1 and xb.shape[0] != len(bbs) * tta:
            raise ValueError(
                f"tta={tta} expects {len(bbs) * tta} crops for {len(bbs)} "
                f"detections, got {xb.shape[0]}"
            )
        z = self._encode(xb)

        if tta > 1 or topk_aggregate > 1:
            stride = self.num_cyclo if upright else 1
            sims, part = cosine_topk(
                z,
                self.embedding_normalized,
                k=self._clamp_k(max(topk_aggregate, 1), stride),
                stride=stride,
                tta=tta,
            )
            Rs, rendered_bbs, idcs = aggregate_candidates(
                self.viewsphere,
                self.embed_obj_bbs,
                part.cpu().numpy(),
                sims.cpu().numpy(),
                agg_angle_deg,
            )
        else:
            if upright:
                _, idcs = cosine_topk(z, self.embedding_normalized, k=1, stride=self.num_cyclo)
                idcs = idcs.cpu().numpy()[:, 0]
            else:
                _, idcs = cosine_top1(z, self._top1_operand)
                idcs = idcs.cpu().numpy()
            Rs = self.viewsphere[idcs].copy()
            rendered_bbs = np.asarray(self.embed_obj_bbs[idcs], dtype=np.float64)

        Rs, ts = self._solve_6d(Rs, rendered_bbs, bbs, K_test, train_cfg, depth_pred)
        return Rs, ts, idcs

    def _solve_6d(
        self,
        Rs: np.ndarray,
        rendered_bbs: np.ndarray,
        bbs: np.ndarray,
        K_test: np.ndarray,
        train_cfg,
        depth_pred: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized translation recovery + off-center rotation correction."""
        bbs = np.asarray(bbs, dtype=np.float64)
        K_train = train_cfg.K
        radius = train_cfg.radius
        K_test = np.asarray(K_test, dtype=np.float64)
        K_diag_ratio = np.sqrt(K_test[0, 0] ** 2 + K_test[1, 1] ** 2) / np.sqrt(
            K_train[0, 0] ** 2 + K_train[1, 1] ** 2
        )

        if depth_pred is None:
            diag_ratio = np.linalg.norm(
                rendered_bbs[:, 2:].astype(np.float32), axis=1
            ) / np.linalg.norm(bbs[:, 2:].astype(np.float32), axis=1)
            z_est = diag_ratio * K_diag_ratio * radius
        else:
            z_est = np.broadcast_to(np.asarray(depth_pred, np.float64), (len(bbs),))

        cx_train = rendered_bbs[:, 0] + rendered_bbs[:, 2] / 2.0 - K_train[0, 2]
        cy_train = rendered_bbs[:, 1] + rendered_bbs[:, 3] / 2.0 - K_train[1, 2]
        cx_test = bbs[:, 0] + bbs[:, 2] / 2.0 - K_test[0, 2]
        cy_test = bbs[:, 1] + bbs[:, 3] / 2.0 - K_test[1, 2]

        tx = cx_test * z_est / K_test[0, 0] - cx_train * radius / K_train[0, 0]
        ty = cy_test * z_est / K_test[1, 1] - cy_train * radius / K_train[1, 1]
        ts = np.stack([tx, ty, z_est], axis=1)

        d_ay = np.arctan(tx / np.sqrt(z_est**2 + ty**2))
        d_ax = -np.arctan(ty / z_est)
        ca, sa = np.cos(d_ax), np.sin(d_ax)
        cb, sb = np.cos(d_ay), np.sin(d_ay)
        zeros = np.zeros_like(ca)
        ones = np.ones_like(ca)
        R_corr_x = np.stack(
            [ones, zeros, zeros, zeros, ca, -sa, zeros, sa, ca], axis=1
        ).reshape(-1, 3, 3)
        R_corr_y = np.stack(
            [cb, zeros, sb, zeros, ones, zeros, -sb, zeros, cb], axis=1
        ).reshape(-1, 3, 3)
        Rs = R_corr_y @ R_corr_x @ Rs
        return Rs, ts

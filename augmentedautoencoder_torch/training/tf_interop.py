"""Import the reference's TF1 checkpoints into the port (port of
augmentedautoencoder_tpu/training/tf_interop.py, without TensorFlow).

The reference ships pretrained TF1 checkpoints whose graphs are built under
`tf.variable_scope(experiment_name)` with tf.layers auto-naming
(auto_pose/ae/encoder.py:38-68, decoder.py:36-84) and keep the codebook as
non-trainable variables in the same checkpoint (codebook.py:27-48).
`training.tf_bundle` reads the checkpoint's files with numpy; the
functions below are the JAX package's, which map the variables into the
Flax parameter tree (tf.layers kernels are HWIO / (in, out), as Flax's),
and `convert.params_from_jax` carries that tree into the port's state dict:

  * encoder variable order: conv2d, conv2d_1, ... then dense (the latent);
    decoder: dense_1 then conv2d_{k+1}... in creation order, with the
    final sigmoid conv last and the optional mask head just before it;
  * codebook: `embedding_normalized` (N, J) f32, `embed_obj_bbs_var` (N, 4).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

from ..convert import params_from_jax
from .checkpoint import CheckpointManager
from .tf_bundle import load_tf_checkpoint_variables


def _layer_index(name: str, base: str) -> int:
    """tf.layers auto-names: 'conv2d' -> 0, 'conv2d_3' -> 3."""
    if name == base:
        return 0
    m = re.match(rf"{base}_(\d+)$", name)
    return int(m.group(1)) if m else -1


def split_reference_variables(
    tf_vars: Dict[str, np.ndarray],
    n_encoder_convs: int,
    n_decoder_convs: int,
    auxiliary_mask: bool = False,
    variational: bool = False,
):
    """Group flat TF vars into (encoder convs, latent dense, decoder dense,
    decoder convs, mask conv, final conv, codebook) by creation order.

    Variational reference checkpoints (encoder.py:70-78) hold THREE denses:
    dense (z), dense_1 (q_sigma, same kernel shape as z), dense_2 (decoder).
    The sigma head is detected by shape and skipped — set `variational` to
    require it (raises if the extra dense is absent)."""
    convs: Dict[int, Dict[str, np.ndarray]] = {}
    denses: Dict[int, Dict[str, np.ndarray]] = {}
    codebook = {}
    for name, value in tf_vars.items():
        parts = name.split("/")
        if parts[0] in ("embedding_normalized", "embed_obj_bbs_var"):
            codebook[parts[0]] = value
            continue
        if len(parts) < 2:
            continue
        layer, var = parts[0], parts[1]
        if var not in ("kernel", "bias"):
            continue  # skip optimizer slots (Adam moments etc.)
        if layer.startswith("conv2d"):
            convs.setdefault(_layer_index(layer, "conv2d"), {})[var] = value
        elif layer.startswith("dense"):
            denses.setdefault(_layer_index(layer, "dense"), {})[var] = value

    conv_order = [convs[i] for i in sorted(convs)]
    dense_order = [denses[i] for i in sorted(denses)]

    enc_convs = conv_order[:n_encoder_convs]
    dec_convs = conv_order[n_encoder_convs:]
    latent = dense_order[0]

    rest = dense_order[1:]
    sigma = None
    # the q_sigma dense has the exact kernel shape of the latent dense;
    # the decoder dense maps latent -> h/2^k * w/2^k * filters[-1]
    if rest and rest[0]["kernel"].shape == latent["kernel"].shape:
        sigma = rest[0]
        rest = rest[1:]
    if variational and sigma is None:
        raise ValueError(
            "variational=True but no q_sigma dense found in the checkpoint "
            f"(dense kernel shapes: {[d['kernel'].shape for d in dense_order]})"
        )
    if sigma is not None and not variational:
        raise ValueError(
            "checkpoint contains a q_sigma dense (variational reference "
            "model) — pass variational=True to import it"
        )
    dec_dense = rest[0] if rest else None

    mask_conv = None
    final_conv = dec_convs[-1] if dec_convs else None
    body_convs = dec_convs[:-1]
    if auxiliary_mask and len(body_convs) >= 1:
        mask_conv = body_convs[-1]
        body_convs = body_convs[:-1]

    return {
        "encoder_convs": enc_convs,
        "latent": latent,
        "latent_sigma": sigma,
        "decoder_dense": dec_dense,
        "decoder_convs": body_convs,
        "mask_conv": mask_conv,
        "final_conv": final_conv,
        "codebook": codebook,
    }


def reference_params_to_flax(
    tf_vars: Dict[str, np.ndarray],
    num_filters: Tuple[int, ...] = (128, 256, 512, 512),
    auxiliary_mask: bool = False,
    variational: bool = False,
) -> Dict:
    """Build the AAE flax params pytree from reference checkpoint variables.

    Returns {'params': ..., 'embedding_normalized': ..., 'embed_obj_bbs': ...}
    (codebook entries only when present in the checkpoint).
    """
    n_enc = len(num_filters)
    groups = split_reference_variables(
        tf_vars, n_enc, n_enc, auxiliary_mask=auxiliary_mask,
        variational=variational,
    )

    def kb(layer):
        return {"kernel": np.asarray(layer["kernel"]), "bias": np.asarray(layer["bias"])}

    encoder = {}
    for i, layer in enumerate(groups["encoder_convs"]):
        encoder[f"Conv_{i}"] = kb(layer)
    encoder["latent"] = kb(groups["latent"])
    if groups["latent_sigma"] is not None:
        encoder["latent_sigma"] = kb(groups["latent_sigma"])

    decoder = {}
    if groups["decoder_dense"] is not None:
        decoder["Dense_0"] = kb(groups["decoder_dense"])
    for i, layer in enumerate(groups["decoder_convs"]):
        decoder[f"Conv_{i}"] = kb(layer)
    if groups["mask_conv"] is not None:
        decoder["mask_head"] = kb(groups["mask_conv"])
    if groups["final_conv"] is not None:
        decoder["reconstruction"] = kb(groups["final_conv"])

    out = {"params": {"encoder": encoder, "decoder": decoder}}
    if "embedding_normalized" in groups["codebook"]:
        out["embedding_normalized"] = np.asarray(
            groups["codebook"]["embedding_normalized"], np.float32
        )
    if "embed_obj_bbs_var" in groups["codebook"]:
        out["embed_obj_bbs"] = np.asarray(
            groups["codebook"]["embed_obj_bbs_var"], np.int32
        )
    return out


def import_reference_checkpoint(
    ckpt_path: str,
    scope: Optional[str],
    checkpoint_dir: str,
    step: int = 0,
    num_filters: Tuple[int, ...] = (128, 256, 512, 512),
    auxiliary_mask: bool = False,
    variational: bool = False,
) -> str:
    """One call: the TF checkpoint -> the port's `chkpt-<step>.pt` (encoder
    and decoder parameters, and the codebook where the checkpoint has one)."""
    tf_vars = load_tf_checkpoint_variables(ckpt_path, scope)
    payload = reference_params_to_flax(
        tf_vars, num_filters=num_filters, auxiliary_mask=auxiliary_mask, variational=variational,
    )
    return CheckpointManager(checkpoint_dir).save(
        step,
        params_from_jax(payload["params"], None, decoder=True),
        embedding_normalized=payload.get("embedding_normalized"),
        embed_obj_bbs=payload.get("embed_obj_bbs"),
    )

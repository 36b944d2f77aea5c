"""Vertex stage: skinning + model transform + reverse-Z projection, batched
over the expanded (draw, vertex) stream.

Parity: renderer/shaders/glsl/main.vert (static + skinned variants).
- Skinned position: model_matrix @ (Σ weight_i · joints[joint_i + offset])
  (main.vert:78-84). Skinning is only computed for the skinned suffix of the
  expanded stream (draws sort static-first, scene.rs:35-41), so static scenes
  pay nothing.
- Normals use the per-draw inverse-transpose matrix, tangents the model 3x3;
  *neither* includes the skin matrix — a reference quirk kept for parity
  (main.vert:86-92). Tangents are Gram-Schmidt orthogonalized against the
  normal here, then interpolated (main.vert:91).

All math is dense [VE, …] jnp — XLA fuses the gathers and the small einsums.

Every position-affecting contraction is pinned to Precision.HIGHEST: an
accelerator may otherwise run f32 contractions at reduced precision (TF32
on a GPU), which would wobble clip positions — visibly on geometry, and
structurally on the integer tile spans that binning derives from them, so
the GPU frame would no longer bin like the CPU oracle. These contractions
are a negligible FLOP share of the frame (contraction dims of 3-4 vs the
raster/shade bulk).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _normalize(v, axis=-1):
    return v * jnp.reciprocal(jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=axis, keepdims=True), 1e-20)))


def _apply_affine(m, p):
    """[..., 3, 4] affine applied to [..., 3] points."""
    return jnp.einsum("...ij,...j->...i", m[..., :3], p, precision=_HI) + m[..., 3]


def run_vertex_stage(geom: dict, frame: dict, skin_start: int | None,
                     morph_k: int = 0) -> dict:
    """geom: device arrays from GeometryStream; frame: per-frame arrays.
    skin_start is a static python int (compiled into the stage): vertices at
    index ≥ skin_start are skinned. Pass None when the stream is not
    partitioned (e.g. sharded over devices) — skinning is then computed for
    every vertex and selected by the per-draw `skinned` flag.

    morph_k (static): number of morph-target weight columns. Morph deltas
    apply BEFORE skinning and the model transform (glTF spec order; the
    reference leaves morph animation as a todo!(), gltf/src/lib.rs:229).
    Unmorphed vertices address the bank's zero row, so the tap is a no-op
    for them; morph_k == 0 compiles the tap out entirely.

    Returns per-expanded-vertex arrays: clip [VE,4], uv [VE,2],
    normal [VE,3], tangent [VE,4], draw [VE] i32.
    """
    src = geom["exp_src"]
    drw = geom["exp_draw"]
    ve = src.shape[0]

    pos = geom["positions"][src]  # [VE,3]
    nrm_base = geom["normals"][src]  # [VE,3]
    if morph_k:
        row0 = geom["morph_row0"][src]  # [VE]
        step = geom["morph_step"][src]  # [VE]
        w = frame["morph_weights"][drw]  # [VE, K]
        for k in range(morph_k):
            tap = row0 + k * step
            pos = pos + w[:, k : k + 1] * geom["morph_pos"][tap]
            # morphed normal = normalize(n + Σ w·dn) — the trailing
            # _normalize below performs the normalization
            nrm_base = nrm_base + w[:, k : k + 1] * geom["morph_nrm"][tap]
    model = frame["transforms"][drw]  # [VE,3,4]

    if skin_start is None:
        jidx = geom["joints"][src] + frame["joints_offset"][drw][:, None]
        jmats = frame["joint_palette"][jidx]  # [VE,4,3,4]
        w = geom["weights"][src]
        skin = jnp.einsum("vj,vjab->vab", w, jmats, precision=_HI)
        rot = jnp.einsum("vij,vjk->vik", model[:, :, :3], skin[:, :, :3],
                         precision=_HI)
        trans = jnp.einsum("vij,vj->vi", model[:, :, :3], skin[:, :, 3],
                           precision=_HI) + model[:, :, 3]
        skinned_model = jnp.concatenate([rot, trans[:, :, None]], axis=2)
        is_skinned = (frame["skinned"][drw] > 0)[:, None, None]
        world = _apply_affine(jnp.where(is_skinned, skinned_model, model), pos)
    elif skin_start < ve:
        s_src = src[skin_start:]
        s_drw = drw[skin_start:]
        jidx = geom["joints"][s_src] + frame["joints_offset"][s_drw][:, None]  # [Vs,4]
        jmats = frame["joint_palette"][jidx]  # [Vs,4,3,4]
        w = geom["weights"][s_src]  # [Vs,4]
        skin = jnp.einsum("vj,vjab->vab", w, jmats, precision=_HI)  # [Vs,3,4]
        m = model[skin_start:]
        rot = jnp.einsum("vij,vjk->vik", m[:, :, :3], skin[:, :, :3],
                         precision=_HI)
        trans = jnp.einsum("vij,vj->vi", m[:, :, :3], skin[:, :, 3],
                           precision=_HI) + m[:, :, 3]
        skinned_model = jnp.concatenate([rot, trans[:, :, None]], axis=2)
        world = jnp.concatenate(
            [_apply_affine(model[:skin_start], pos[:skin_start]),
             _apply_affine(skinned_model, pos[skin_start:])],
            axis=0,
        )
    else:
        world = _apply_affine(model, pos)

    pv = frame["proj_view"]  # [4,4] = projection @ view
    clip = jnp.matmul(world, pv[:, :3].T, precision=_HI) + pv[:, 3]  # [VE,4]

    normal = _normalize(jnp.einsum("vij,vj->vi", frame["normal_mats"][drw],
                                    nrm_base, precision=_HI))
    tang4 = geom["tangents"][src]
    tang = _normalize(jnp.einsum("vij,vj->vi", model[:, :, :3], tang4[:, :3],
                                  precision=_HI))
    # Gram-Schmidt: ensure 90° between normal and tangent (main.vert:91).
    tang = _normalize(tang - jnp.sum(tang * normal, axis=-1, keepdims=True) * normal)
    tangent = jnp.concatenate([tang, tang4[:, 3:4]], axis=1)

    return {
        "clip": clip,
        "uv": geom["uvs"][src],
        "normal": normal,
        "tangent": tangent,
        "draw": drw,
    }

"""The GPipe schedule of the LXMERT encoder (counterpart of
`xggm_tpu/parallel/pipeline_lxmert.py`).

The encoder is not homogeneous: 9 language layers, then 5 visual ones,
then 5 cross-modality layers, of two layer types over two streams. As in
the JAX package it runs as one sequence of virtual layers, lang 0..L_l-1,
visn 0..L_v-1, x 0..L_x-1, padded with identity layers to a multiple of the
stage count S, stage s running virtual layers [s L_pad / S, (s + 1) L_pad /
S) (`stage_layout`, the kinds and padding of JAX's
`build_superset_stack`).

The JAX package builds a superset [L_pad, ...] stack of zero-filled slots so
that its SPMD program can scan over it. The port needs none: each virtual
layer runs the real layer of its kind on its stack's slice
(`models/lxmert.py::LayerStack`). The carry holds the two streams as two
tensors, {lang: [B, Lt, H], visn: [B, Lv, H], lang_bias, visn_bias}, where
JAX's carries one [B, Lt + Lv, H] tensor read by rows: a language layer
updates `lang`, a visual one `visn`, a cross layer both, its
cross-attention reading the inputs from before the update. The per-example
attention biases travel with their microbatch. Only `lang` and `visn`
carry gradients between stages, so a stream the loss does not read (the
clean phase's visual output) sends back no gradient and its last layer's
backward does not run, as on one rank.

`remat` wraps each virtual layer in `models/lxmert.py::_remat`. Dropout:
each microbatch draws its masks from the step's generator in turn, so the
draws differ from a single rank's (and from JAX's, which repeats one key
per layer across microbatches); parity tests run with dropout off.

The mesh is set once per process (`set_pipeline_mesh`; the trainers do it
when `pp_stages` > 1), as JAX's process-global pipeline context.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from xggm_tpu_torch.parallel.mesh import Mesh
from xggm_tpu_torch.parallel.pipeline import NotLastStage, run_pipeline

KIND_LANG, KIND_VISN, KIND_X, KIND_IDENT = 0, 1, 2, 3

_PP_CONTEXT: Optional[Dict[str, Any]] = None


def set_pipeline_mesh(mesh: Mesh, n_microbatches: int = 4) -> None:
    """Pipeline every `pp_stages` encoder of this process over `mesh`'s
    pipe group, in `n_microbatches` microbatches."""
    if mesh.pipe_size < 2:
        raise ValueError(f"the mesh has no pipe axis (pipe group of "
                         f"{mesh.pipe_size}); build it with "
                         "make_mesh(pipeline_parallel=N)")
    global _PP_CONTEXT
    _PP_CONTEXT = dict(mesh=mesh, n_microbatches=n_microbatches)


def clear_pipeline_mesh() -> None:
    global _PP_CONTEXT
    _PP_CONTEXT = None


def get_pipeline_context() -> Dict[str, Any]:
    if _PP_CONTEXT is None:
        raise RuntimeError(
            "pp_stages > 1 but no pipeline mesh is set: call "
            "parallel.set_pipeline_mesh(mesh, ...) before running the model "
            "(the trainers do this when pp_stages > 1)")
    return _PP_CONTEXT


def pipeline_mesh() -> Optional[Mesh]:
    """The pipeline mesh of this process, None when none is set."""
    return None if _PP_CONTEXT is None else _PP_CONTEXT["mesh"]


def stage_layout(n_lang: int, n_visn: int, n_x: int, n_stages: int
                 ) -> Tuple[List[int], List[int]]:
    """(kind, index in its stack) of every virtual layer: lang, visn, x,
    then identity layers up to a multiple of `n_stages`."""
    kinds = ([KIND_LANG] * n_lang + [KIND_VISN] * n_visn + [KIND_X] * n_x)
    index = list(range(n_lang)) + list(range(n_visn)) + list(range(n_x))
    pad = -len(kinds) % n_stages
    return kinds + [KIND_IDENT] * pad, index + list(range(pad))


def stage_plan(encoder, stage: int, n_stages: int) -> List[Tuple[int, int]]:
    """The (kind, index) of the virtual layers stage `stage` runs."""
    kinds, index = stage_layout(encoder.lang_stack.length,
                                encoder.r_stack.length,
                                encoder.x_stack.length, n_stages)
    per = len(kinds) // n_stages
    return list(zip(kinds, index))[stage * per:(stage + 1) * per]


def _virtual_layer(encoder, kind: int, i: int, rng):
    """carry -> carry for one virtual layer."""
    from xggm_tpu_torch.models.lxmert import _remat

    def call(stack, *args):
        layer = stack.layer_fn(i)
        if encoder.remat:
            return _remat(layer, rng, *args)
        return layer(*args, rng)

    def apply(c):
        if kind == KIND_LANG:
            return {**c, "lang": call(encoder.lang_stack, c["lang"],
                                      c["lang_bias"])}
        if kind == KIND_VISN:
            return {**c, "visn": call(encoder.r_stack, c["visn"],
                                      c.get("visn_bias"))}
        if kind == KIND_X:
            lang, visn = call(encoder.x_stack, c["lang"], c["lang_bias"],
                              c["visn"], c.get("visn_bias"))
            return {**c, "lang": lang, "visn": visn}
        return c

    return apply


def pipelined_lxr_stack(encoder, lang: Optional[torch.Tensor],
                        visn: Optional[torch.Tensor],
                        lang_bias: torch.Tensor,
                        visn_bias: Optional[torch.Tensor], rng, *,
                        visn_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lang -> visn -> x layer sequence of `encoder` (a stacked
    `LxmertEncoder`) as a GPipe pipeline over the pipeline mesh. Stage 0
    passes the embedded `lang` and `visn`; the later stages pass None for
    both (their shapes come from `lang_bias` and `visn_len`). Returns
    (lang, visn) on the last stage; raises NotLastStage on the others."""
    ctx = get_pipeline_context()
    mesh, n_mb = ctx["mesh"], ctx["n_microbatches"]
    if mesh.pipe_size != encoder.pp_stages:
        raise ValueError(f"config.pp_stages={encoder.pp_stages} but the "
                         f"pipeline mesh's pipe group has {mesh.pipe_size} "
                         "ranks")
    if mesh.pipe_rank == 0:
        carry = {"lang": lang, "visn": visn, "lang_bias": lang_bias}
        if visn_bias is not None:
            carry["visn_bias"] = visn_bias
    else:
        b, lt = lang_bias.shape
        hid, dt = encoder.hidden_size, encoder.dtype

        def meta(*shape, dtype=dt):
            return torch.empty(shape, dtype=dtype, device="meta")

        carry = {"lang": meta(b, lt, hid), "visn": meta(b, visn_len, hid),
                 "lang_bias": meta(b, lt, dtype=torch.float32)}
        if visn_bias is not None:
            carry["visn_bias"] = meta(b, visn_len, dtype=torch.float32)
    layers = [_virtual_layer(encoder, kind, i, rng)
              for kind, i in stage_plan(encoder, mesh.pipe_rank,
                                        mesh.pipe_size)]

    def stage_fn(c):
        for layer in layers:
            c = layer(c)
        return c

    out = run_pipeline(stage_fn, carry, mesh, n_mb,
                       grad_keys=("lang", "visn"))
    if out is None:
        raise NotLastStage()
    return out["lang"], out["visn"]

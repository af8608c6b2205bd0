"""Multi-device dry-run (the port of ``repro.launch.dryrun``): trace every
(architecture x input shape) cell's step on the production meshes, (16, 16)
= 256 devices and (2, 16, 16) = 512, then extract the roofline terms per
device (flops, HBM bytes and collective bytes by kind, from
``hlo_analysis.analyze`` of the traced graph) and the memory per device.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --shape train_4k --tuned [--remat full]

Results are cached as JSON under build/dryrun/.  No card is needed.

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices.  The port joins a fake process group of the mesh's size as
its rank 0 (``mesh.make_dryrun_mesh``), builds the cell's step with
``steps.build`` on that mesh, makes its inputs FakeTensors on ``DEVICE``
(the rank's local shards of the parameters, moments and cache, which the
traced function lays out as DTensors by their specs; the rank's block of
the batch) and records the step with ``make_fx``: an aten graph whose
nodes carry shapes alone, the collectives DTensor issues as
``_c10d_functional`` nodes, K4 and K5 as their operators' nodes.  The
numbers are the port's own step's: under the "tp" style every family's
train, prefill and decode steps compute on their model shards, as the
reference's tensor-parallel step does (their flops a device are the
reference's, or apart from them by products the tests name), the decode
step on its block of the cache; the "fsdp" and "ep" styles gather each
weight whole (ZeRO-3) and split the batch over every axis.  Every style
gathers a layer's weights at the layer (``steps``): ``gather_bound`` is
what a train step's live all-gathered bytes should stay under, and
``hlo_analysis.live_at_peak`` what they are at the graph's peak.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import math
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import _cuda
from repro_torch.config import SHAPES, all_cells, get_config, tune
from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.parallel import sharding

RESULTS = os.path.join(_cuda.BUILD_DIR, "dryrun")
# the FakeTensors' device: the card's where this PyTorch is built for CUDA.
# A build without CUDA cannot index a FakeTensor on "cuda" (Python indexing
# takes a CUDA device guard, which only CUDA builds have), so there they lie
# on "cpu"; the traced graph is the same, its nodes' device aside.
DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"


@dataclasses.dataclass
class Traced:
    """A cell's step traced on one rank of a fake group: ``gm`` the graph,
    ``args`` its FakeTensor inputs (the rank's shards and batch block),
    ``step(*args)`` the step itself on them, ``fake`` their mode,
    ``seconds`` the trace's."""
    gm: torch.fx.GraphModule
    args: list
    step: object
    fake: FakeTensorMode
    seconds: float


@contextlib.contextmanager
def dryrun_mesh(shape: tuple, names: tuple):
    """``mesh.make_dryrun_mesh(shape, names, DEVICE)``, its fake group
    destroyed on the way out."""
    mesh = mesh_mod.make_dryrun_mesh(shape, names, DEVICE)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def trace_step(cfg, shape, mesh) -> Traced:
    """``steps.build(cfg, shape, mesh)``'s step traced with ``make_fx`` on
    FakeTensor inputs: the parameters, the moments (train) and the cache
    (decode) as the rank's local shards, made DTensors inside the traced
    function by their specs; the optimiser's count and the rank's block of
    the batch as plain tensors.  DTensor outputs are returned as their
    local shards."""
    fn, in_specs, _, abstract = steps_mod.build(cfg, shape, mesh)
    coord = mesh.get_coordinate()
    fake = FakeTensorMode()
    leaves = []         # (meta tensor, spec, as a DTensor)

    def add(t, spec, dtensor: bool) -> int:
        leaves.append((t, spec, dtensor))
        return len(leaves) - 1

    def mark(tree, specs, dtensor: bool):
        """``tree`` with each tensor leaf replaced by its index in
        ``leaves``."""
        if isinstance(tree, dict):
            return {k: mark(v, specs[k], dtensor) for k, v in tree.items()}
        if isinstance(tree, list):
            return [mark(v, s, dtensor) for v, s in zip(tree, specs)]
        return add(tree, specs, dtensor)

    if shape.kind == "train":
        (pspecs, ospecs, bspecs), (params, opt, batch) = in_specs, abstract
        tree = (mark(params, pspecs, True),
                {"m": mark(opt["m"], ospecs["m"], True),
                 "v": mark(opt["v"], ospecs["v"], True),
                 "count": mark(opt["count"], ospecs["count"], False)},
                mark(batch, bspecs, False))
    elif shape.kind == "prefill":
        (pspecs, bspecs), (params, batch) = in_specs, abstract
        tree = (mark(params, pspecs, True), mark(batch, bspecs, False))
    else:
        (pspecs, cspecs, bspecs), (params, cache, batch) = in_specs, abstract
        tree = (mark(params, pspecs, True), mark(cache, cspecs, True),
                mark(batch, bspecs, False))
    shapes = [t[sharding.local_block(spec, tuple(t.shape), mesh,
                                     coord)].shape for t, spec, _ in leaves]
    with fake:
        args = [torch.empty(s, dtype=t.dtype, device=mesh.device_type)
                for s, (t, _, _) in zip(shapes, leaves)]
    if not all(map(_cuda.is_fake, args)):
        raise RuntimeError("dry-run inputs must be FakeTensors: the fake "
                           "group's collectives never communicate")

    def build(tree, flat):
        if isinstance(tree, dict):
            return {k: build(v, flat) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, flat) for v in tree)
        t, spec, dtensor = leaves[tree]
        if not dtensor:
            return flat[tree]
        return DTensor.from_local(flat[tree], mesh,
                                  sharding.placements(spec, mesh),
                                  run_check=False)

    def local(out):
        if isinstance(out, DTensor):
            return out.to_local()
        if isinstance(out, dict):
            return {k: local(v) for k, v in out.items()}
        if isinstance(out, (list, tuple)):
            return type(out)(local(v) for v in out)
        return out

    def step(*flat):
        return local(fn(*build(tree, flat)))

    t0 = time.perf_counter()
    gm = make_fx(step, tracing_mode="fake")(*args)
    return Traced(gm, args, step, fake, time.perf_counter() - t0)


def gathered_weight_bytes(cfg, mesh) -> dict:
    """{dotted name: bytes} of each weight as a device of ``mesh`` (a
    DeviceMesh or a ``(shape, names)`` spec) all-gathers it in ``cfg``'s
    train or prefill step: the weight whole, or under tensor-parallel
    compute its model shard; 0 where no collective gathers it."""
    model, names, pspecs = steps_mod._model_specs(cfg, mesh)
    split = steps_mod._tensor_parallel(cfg, mesh)
    sizes = list(mesh_mod.mesh_shape(mesh).values())
    out = {}
    for name, p, spec in zip(names, model.param_list(), pspecs):
        place = sharding.placements(spec, mesh)
        keep = steps_mod._keep_model([place], mesh, split)[0]
        moved = any(pl.is_shard() and not k.is_shard() and n > 1
                    for pl, k, n in zip(place, keep, sizes))
        kept = math.prod(n for k, n in zip(keep, sizes) if k.is_shard())
        out[name] = p.numel() * p.element_size() // kept if moved else 0
    return out


def gather_bound(cfg, mesh) -> int:
    """The all-gathered bytes a train step of ``cfg`` may hold at once
    when it gathers each layer's weights at the layer: two layers' (the
    largest layer's twice: one in use, the next arriving) plus every
    weight outside the layers (the embedding, the head, the norms,
    PaliGemma's image projection)."""
    layers: dict = collections.Counter()
    rest = 0
    for name, b in gathered_weight_bytes(cfg, mesh).items():
        part = name.split(".")
        if part[0] in ("blocks", "encoder"):
            layers[tuple(part[:2])] += b
        else:
            rest += b
    return 2 * max(layers.values(), default=0) + rest


def counted_flops(traced: Traced) -> int:
    """``FlopCounterMode``'s total over the step run again on its FakeTensor
    inputs: torch's own count beside the graph's."""
    with traced.fake, FlopCounterMode(display=False) as counter:
        traced.step(*traced.args)
    return counter.get_total_flops()


def record(arch_id: str, shape_name: str, mesh_name: str, cfg, shape,
           mesh, traced: Traced) -> dict:
    """The reference's record of a cell, from its traced step."""
    ana = hlo_analysis.analyze(traced.gm)
    out_node = next(n for n in traced.gm.graph.nodes if n.op == "output")
    return {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": int(mesh.size()),
        "flops_per_device": ana["flops"],
        "hbm_bytes_per_device": ana["bytes"],
        "collective_bytes_per_device": ana["collective_bytes"],
        "while_trips": ana["trips"],
        "entry_cost_analysis": {"flops": counted_flops(traced)},
        "memory": {
            "argument_size": hlo_analysis.nbytes(traced.args),
            "output_size": sum(hlo_analysis.nbytes(n.meta.get("val"))
                               for n in out_node.all_input_nodes),
            "temp_size": hlo_analysis.peak_live_bytes(traced.gm),
            # a traced graph runs op by op: no code is generated for it
            "generated_code_size": 0,
        },
        "compile_seconds": round(traced.seconds, 1),
        "model_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "kind": shape.kind,
    }


def dryrun_cell(arch_id: str, shape_name: str, multi_pod: bool,
                cfg_override=None, *, shape=None, mesh=None,
                gathers: dict | None = None) -> dict:
    """Trace one cell's step and extract its roofline inputs: the
    reference's record (``record``).  ``shape`` (a ``ShapeConfig``) stands
    in for ``SHAPES[shape_name]`` and ``mesh`` (a ``(shape, names)`` pair)
    for the production mesh, for cells of other sizes.  ``gathers``, a
    dict, receives the all-gathered bytes alive at the graph's peak
    ("live", ``hlo_analysis.live_at_peak``) and ``gather_bound``'s
    ("bound").  The fake group lives for the call alone."""
    cfg = cfg_override or get_config(arch_id)
    shape = shape or SHAPES[shape_name]
    spec = mesh or mesh_mod.production_mesh_spec(multi_pod)
    with dryrun_mesh(*spec) as m:
        traced = trace_step(cfg, shape, m)
        if gathers is not None:
            gathers["live"] = hlo_analysis.live_at_peak(traced.gm).get(
                "all_gather_into_tensor", 0)
            gathers["bound"] = gather_bound(cfg, m)
        return record(arch_id, shape_name, "multi" if multi_pod else "single",
                      cfg, shape, m, traced)


def main(argv=None, results: str = RESULTS):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tuned", action="store_true",
                    help="apply config.tune's levers")
    ap.add_argument("--remat", default=None, choices=["none", "full", "dots"],
                    help="the remat mode instead of the config's (after "
                    "--tuned)")
    args = ap.parse_args(argv)

    os.makedirs(results, exist_ok=True)
    cells = []
    if args.all:
        for aid, sname, ok, why in all_cells():
            if args.arch and aid != args.arch or \
                    args.shape and sname != args.shape:
                continue
            cells.append((aid, sname, ok, why))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, True, "")]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_ok = n_skip = n_fail = 0
    for aid, sname, ok, why in cells:
        for mp in meshes:
            tag = f"{aid}_{sname}_{'multi' if mp else 'single'}" + \
                ("_tuned" if args.tuned else "") + \
                (f"_{args.remat}" if args.remat else "")
            path = os.path.join(results, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[cached] {tag}")
                n_ok += 1
                continue
            if not ok:
                with open(path, "w") as f:
                    json.dump({"arch": aid, "shape": sname,
                               "mesh": "multi" if mp else "single",
                               "skipped": why}, f, indent=1)
                print(f"[skip]   {tag}: {why}")
                n_skip += 1
                continue
            try:
                t0 = time.time()
                ovr = tune(get_config(aid), SHAPES[sname],
                           n_chips=512 if mp else 256) if args.tuned else None
                if args.remat:
                    ovr = dataclasses.replace(ovr or get_config(aid),
                                              remat=args.remat)
                gathers: dict = {}
                rec = dryrun_cell(aid, sname, mp, cfg_override=ovr,
                                  gathers=gathers)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[ok]     {tag}: flops/dev={rec['flops_per_device']:.3e} "
                      f"coll={sum(rec['collective_bytes_per_device'].values()):.3e}B "
                      f"temp={rec['memory']['temp_size']}B "
                      f"gathers live at the peak={gathers['live']}B "
                      f"(two layers' + the rest {gathers['bound']}B) "
                      f"({time.time()-t0:.0f}s)")
                n_ok += 1
            except Exception as e:  # a cell that cannot be traced: its .err
                n_fail += 1
                err = f"{type(e).__name__}: {e}"
                with open(path + ".err", "w") as f:
                    json.dump({"arch": aid, "shape": sname,
                               "mesh": "multi" if mp else "single",
                               "error": err[:2000]}, f)
                print(f"[FAIL]   {tag}: {err[:300]}")
                traceback.print_exc(limit=3)
    print(f"dryrun: {n_ok} ok, {n_skip} skipped, {n_fail} failed")


if __name__ == "__main__":
    main()

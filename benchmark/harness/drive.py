"""One run of one cell: set-up, the measured window, the traced segment, the
check against the plain reference.

The program is ``maed_tpu_torch``, driven through its own entry points:
``core.builder.build_eval_model`` and the model's forward for a served
cell, ``core.builder.build_train_model``, ``parallel.train_step.
make_optimizer`` and ``make_train_step`` for a training cell. The harness
hands it the weights and the body it drew from the seed and the batches of
the traffic pool; it reads back the outputs, the losses, Adam's state and
the parameters, and ``kernels.LAUNCHES``.

A served cell is a closed loop of one client: each request is due when the
previous answer landed, its clips go up from pinned host memory, the five
outputs come down to pinned host memory, and its latency runs from due to
landed. A training cell runs the step back to back, each step's batch
uploaded from pinned memory on the step's stream, at most two steps in
flight; set-up drives the same step object through its first steps, which
the reference then follows.
"""

from __future__ import annotations

import json
import math
import random
import time
import types
from dataclasses import dataclass, field
from pathlib import Path

import torch

from benchmark.counts.maed import forward_flops, kernel_ops
from benchmark.counts.peaks import least_time
from benchmark.harness import check, trace, traffic
from benchmark.harness.weights import make_weights, trainable
from benchmark.reference import loss as ref_loss
from benchmark.reference import model as ref_model
from benchmark.reference.body import SMPL_PARENTS, make_body
from benchmark.reference.precision import Precision

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
# sub-seeds of a run, by what they draw
WEIGHTS, BODY, TRAFFIC, DROPOUT, SAMPLE = range(5)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict


def load_cell(bench: dict, name: str) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    limits_file = BENCH / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.is_file() else {}
    return Cell(name, entry["chips"], config, mix, limits)


@dataclass
class Observed:
    """What a run saw; the metric readers (``benchmark/metrics``) take it."""
    cell: Cell
    setup_s: float = math.nan
    build_s: float = math.nan
    window_s: float = math.nan
    items: int = 0                     # requests or steps completed in the window
    clips: int = 0                     # clips whose answers landed in the window
    latencies_s: list = field(default_factory=list)
    enqueue_s: list = field(default_factory=list)
    item_flops: float = 0.0            # model FLOPs of one request or step
    item_kernel_least_s: float = 0.0   # least time of the port-kernel operations of one
    traced: dict | None = None         # trace.summarize of the traced segment
    launches: dict = field(default_factory=dict)


def configure(device) -> None:
    """cuDNN's autotune on, as the CLIs run it (CUDNN.BENCHMARK), TF32 off."""
    torch.backends.cudnn.benchmark = device.type == "cuda"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def smpl_model(body: dict):
    from maed_tpu_torch.ops.smpl import SMPLModel
    return SMPLModel(v_template=body["v_template"], shapedirs=body["shapedirs"],
                     posedirs=body["posedirs"], J_regressor=body["J_regressor"],
                     lbs_weights=body["lbs_weights"], parents=SMPL_PARENTS,
                     vertex_joint_ids=body["vertex_joint_ids"],
                     J_regressor_extra=body["J_regressor_extra"],
                     joint_select=body["joint_select"])


def builder_kwargs(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("encoder", "decoder", "num_blocks", "num_heads", "hidden_dim",
                                "img_size", "st_mode")}


def _dtype(mix):
    return {"bf16": torch.bfloat16, "f32": torch.float32}[mix["dtype"]]


class Run:
    def __init__(self, cell: Cell, seed: int, device, t_start: float):
        self.cell, self.seed, self.device, self.t_start = cell, seed, device, t_start
        self.cfg, self.mix = cell.config, cell.mix
        self.obs = Observed(cell)
        if self.mix["size"] != self.cfg["img_size"]:
            raise ValueError(f"{cell.name}: the mix's frames are {self.mix['size']} px, the "
                             f"configuration's {self.cfg['img_size']}")

    def sub(self, what: int) -> int:
        return self.seed * 8 + what

    # ------------------------------------------------------------ set-up
    def setup(self):
        from maed_tpu_torch import kernels
        from maed_tpu_torch.core import builder

        configure(self.device)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            kernels.build()
        self.body = make_body(self.sub(BODY), self.device, self.cfg["num_verts"])
        state = make_weights(self.cfg, self.sub(WEIGHTS), self.device)
        build = builder.build_eval_model if self.mix["kind"] == "infer" else \
            builder.build_train_model
        self.model, _ = build(**builder_kwargs(self.cfg), dtype=_dtype(self.mix),
                              device=self.device, state_dict=state, allow_synthetic_smpl=True)
        del state
        self.obs.build_s = time.perf_counter() - t0
        self.smpl = smpl_model(self.body)
        self.pool = traffic.make_pool(self.mix, self.sub(TRAFFIC), self.body, self.device)
        if self.mix["kind"] == "infer":
            self._setup_infer()
        else:
            self._setup_train()
        sync(self.device)
        self.obs.setup_s = time.perf_counter() - self.t_start

    def _setup_infer(self):
        mix, cfg = self.mix, self.cfg
        self.jreg = self.body["jreg14"]
        self.obs.item_flops = forward_flops(cfg, mix["clips"], mix["frames"], True)
        self.obs.item_kernel_least_s = sum(
            least_time(f, b, dt) for _, f, b, dt in kernel_ops(cfg, mix["clips"], mix["frames"],
                                                                mix["dtype"]))
        out = self.model(traffic.to_device(self.pool[0], self.device), self.smpl,
                         J_regressor=self.jreg)
        # the answers land here: the sampled requests' buffers and a working one
        self.buffers = [{k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=self.device.type == "cuda")
                         for k, v in out.items()} for _ in range(mix["sample"] + 1)]
        for i in range(mix["warmup"]):
            self._request(i, self.buffers[0])

    def _request(self, i: int, buf: dict) -> tuple[float, float]:
        """Request i: up, forward, down. Returns (host s of the forward's
        call, perf_counter when the answers have landed)."""
        clips = traffic.to_device(self.pool[i % len(self.pool)], self.device)
        t_call = time.perf_counter()
        out = self.model(clips, self.smpl, J_regressor=self.jreg)
        enqueue = time.perf_counter() - t_call
        for k, v in out.items():
            buf[k].copy_(v, non_blocking=True)
        sync(self.device)
        return enqueue, time.perf_counter()

    def _setup_train(self):
        from maed_tpu_torch.core.loss import LossWeights
        from maed_tpu_torch.parallel import train_step

        mix, cfg = self.mix, self.cfg
        frames = [(mix["clips_2d"] + mix["clips_3d"], mix["frames"]), (mix["images"], 1)]
        self.obs.item_flops = 3 * sum(forward_flops(cfg, n, T, False) for n, T in frames if n)
        self.obs.item_kernel_least_s = sum(
            least_time(f, b, dt) for n, T in frames if n
            for _, f, b, dt in kernel_ops(cfg, n, T, mix["dtype"]))
        optim = types.SimpleNamespace(**cfg["optim"])
        self.opt = train_step.make_optimizer(optim, cfg["steps_per_epoch"],
                                             self.model.parameters())
        generator = torch.Generator(device=self.device).manual_seed(self.sub(DROPOUT))
        self.step = train_step.make_train_step(self.model, self.opt, self.smpl,
                                               LossWeights(**cfg["loss"]), generator)
        named = dict(self.model.named_parameters())
        start = {n: p.detach().clone() for n, p in named.items()}
        losses = []
        beta1 = self.opt.optimizer.param_groups[0]["betas"][0]
        for s in range(mix["checked_steps"]):
            losses.append(self.step(*traffic.to_device(self.pool[s], self.device))["loss"])
            if s == 0:
                state = self.opt.optimizer.state
                grad = check.leaf_norms({n: state[p]["exp_avg"] / (1 - beta1) if p in state
                                         else p.new_zeros(()) for n, p in named.items()})
        update = check.leaf_norms({n: p.detach() - start[n] for n, p in named.items()})
        del start
        self.first_steps = {"losses": [float(x) for x in losses], "grad": grad,
                            "update": update}
        self.next_batch = mix["checked_steps"]

    # ------------------------------------------------------------ the window
    def window(self, seconds: float):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        from maed_tpu_torch import kernels
        kernels.reset_launches()
        if self.mix["kind"] == "infer":
            self._window_infer(seconds)
        else:
            self._window_train(seconds)
        self.obs.launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)

    def _window_infer(self, seconds):
        K, n = self.mix["sample"], self.mix["clips"]
        rng = random.Random(self.sub(SAMPLE))
        self.kept, work = [], 0
        obs = self.obs
        t0 = time.perf_counter()
        end, due, i = t0 + seconds, t0, 0
        while due < end:
            enqueue, landed = self._request(i, self.buffers[work])
            obs.latencies_s.append(landed - due)
            obs.enqueue_s.append(enqueue)
            if landed <= end:
                obs.clips += n
            # a uniform sample of K of the window's answers (reservoir sampling)
            pool_i = i % len(self.pool)
            if len(self.kept) < K:
                self.kept.append((pool_i, work))
                work = len(self.kept)
            else:
                j = rng.randrange(i + 1)
                if j < K:
                    self.kept[j], work = (pool_i, work), self.kept[j][1]
            due, i = landed, i + 1
        obs.items, obs.window_s, self.work = i, seconds, work

    def _train_one(self):
        batch = traffic.to_device(self.pool[self.next_batch % len(self.pool)], self.device)
        self.next_batch += 1
        out = self.step(*batch)
        event = torch.cuda.Event() if self.device.type == "cuda" else None
        if event is not None:
            event.record()
        return out, event

    def _window_train(self, seconds):
        t0 = time.perf_counter()
        end, steps, prev = t0 + seconds, 0, None
        while time.perf_counter() < end:
            _, event = self._train_one()
            if prev is not None:
                prev.synchronize()  # at most two steps in flight
            prev, steps = event, steps + 1
        sync(self.device)
        self.obs.items, self.obs.window_s = steps, time.perf_counter() - t0

    # ------------------------------------------------------------ the traced segment
    def traced(self):
        n = self.mix["trace_items"]
        with trace.profiler() as prof:
            with torch.profiler.record_function(trace.WINDOW):
                for i in range(n):
                    if self.mix["kind"] == "infer":
                        self._request(i, self.buffers[self.work])
                    else:
                        self._train_one()
                sync(self.device)
        pattern = trace.port_kernel_pattern(ROOT / "maed_tpu_torch" / "csrc")
        self.obs.traced = trace.summarize(prof, pattern, n)

    # ------------------------------------------------------------ the check
    def free_program(self):
        for name in ("model", "opt", "step", "smpl"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_numbers(self, program=None) -> dict:
        """The compared numbers of the program's answers (or of ``program``'s,
        a stand-in's) against the plain reference."""
        if self.mix["kind"] == "infer":
            refs = [self.reference_outputs(pool_i) for pool_i, _ in self.kept]
            progs = [self.buffers[buf] if program is None else program(pool_i)
                     for pool_i, buf in self.kept]
            return check.answer_gaps(progs, refs)
        ref = self.reference_steps()
        return check.train_gaps(self.first_steps if program is None else program(), ref)

    @torch.no_grad()
    def reference_outputs(self, pool_i: int, precision: str = "f32") -> dict:
        """The reference's five outputs of pool batch ``pool_i``, on the host,
        computed in blocks of clips (those in f32 kept for the next ask)."""
        cache = self.__dict__.setdefault("_ref_out", {})
        if precision == "f32" and pool_i in cache:
            return cache[pool_i]
        params = self._ref_params()
        clips = self.pool[pool_i]
        block, outs = self.mix["reference_block"], []
        for c in range(0, clips.shape[0], block):
            x = clips[c:c + block].to(self.device)
            out = ref_model.forward(params, x, self.body, self.cfg, Precision(precision),
                                    jreg=self.body["jreg14"])
            outs.append({k: v.float().cpu() for k, v in out.items()})
        result = {k: torch.cat([o[k] for o in outs]) for k in check.OUTPUTS}
        if precision == "f32":
            cache[pool_i] = result
        return result

    def _ref_params(self):
        if getattr(self, "_params", None) is None:
            self._params = make_weights(self.cfg, self.sub(WEIGHTS), self.device)
        return self._params

    def reference_steps(self, tf32: bool = False, half_batch: bool = False) -> dict:
        """The checked steps of the plain reference from the same weights,
        batches and dropout seed: the losses, the first gradient's norms as
        Adam takes it and the change's norms after the last (kept for the
        next ask without a control or fault)."""
        if not (tf32 or half_batch) and getattr(self, "_ref_steps", None):
            return self._ref_steps
        cfg, mix = self.cfg, self.mix
        params = make_weights(cfg, self.sub(WEIGHTS), self.device)
        names = trainable(params)
        start = {n: params[n].clone() for n in names}
        for n in names:
            params[n].requires_grad_(True)
        adam = ref_loss.Adam({n: params[n] for n in names}, cfg["optim"]["LR"],
                             cfg["optim"]["WD"])
        g = torch.Generator(device=self.device).manual_seed(self.sub(DROPOUT))
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        losses, grad = [], None
        try:
            for s in range(mix["checked_steps"]):
                vid, img = traffic.to_device(self.pool[s], self.device)
                if half_batch:
                    vid, img = _half(vid, mix), _half(img, mix)
                vp = None if vid is None else ref_model.forward(
                    params, vid["images"], self.body, cfg, train=True, generator=g)
                ip = ref_model.forward(params, img["image"][:, None], self.body, cfg, train=True,
                                       generator=g)
                total = ref_loss.step_loss(vp, vid, ip, img, cfg["loss"])
                grads = torch.autograd.grad(total, [params[n] for n in names])
                taken = adam.step(dict(zip(names, grads)))
                losses.append(total.item())
                if s == 0:
                    grad = check.leaf_norms(taken)
                del vp, ip, total, grads, taken
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        update = check.leaf_norms({n: params[n].detach() - start[n] for n in names})
        result = {"losses": losses, "grad": grad, "update": update}
        if not (tf32 or half_batch):
            self._ref_steps = result
        return result


def _half(batch, mix):
    """A fault of a training step: half of the batch left out (half of the
    2D clips, of the 3D clips and of the images), the mean over the rest."""
    if batch is None:
        return None
    if "image" in batch:
        return {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}
    n2d, n3d = mix["clips_2d"], mix["clips_3d"]
    keep2, keep3 = n2d // 2, max(1, n3d // 2)
    clips = torch.cat([batch["images"][:keep2], batch["images"][n2d:n2d + keep3]])
    out = {"images": clips,
           "target_3d": {k: v[:keep3] for k, v in batch["target_3d"].items()}}
    if keep2:
        out["target_2d"] = {"kp_2d": batch["target_2d"]["kp_2d"][:keep2]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """The run's result (without its ``device`` entry) and the Observed."""
    run = Run(cell, seed, device, t_start)
    run.setup()
    run.window(seconds)
    if traced:
        run.traced()
    run.free_program()
    numbers = run.reference_numbers()
    correct, checks = check.verdict(numbers, cell.limits)
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    return {"correct": correct, "attempted": run.obs.items, "failed": failed,
            "memory_peak": run.memory_peak, "checks": checks, "obs": run.obs}

"""Global runtime flag registry.

A copy of ``paddle_tpu/core/flags.py`` (pure Python), so the port reads
the same flags with the same names, defaults and ``FLAGS_<name>``
environment overrides (ref: paddle/fluid/platform/flags.cc; python
get/set via pybind/global_value_getter_setter.cc:337). The static
executor reads ``check_nan_inf`` and ``executor_cache_programs``; the
other flags are kept so a script that sets them runs unchanged.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}
_TYPES: Dict[str, type] = {}


def _coerce(name: str, value):
    ty = _TYPES[name]
    if ty is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    return ty(value)


def define_flag(name: str, default, help_: str = ""):
    _TYPES[name] = type(default)
    env = os.environ.get("FLAGS_" + name)
    _REGISTRY[name] = _coerce(name, env) if env is not None else default


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    return {n: _REGISTRY[n] for n in names}


def get_flag(name: str):
    return _REGISTRY[name]


def set_flags(flags: Dict[str, Any]):
    for name, value in flags.items():
        if name.startswith("FLAGS_"):
            name = name[len("FLAGS_"):]
        if name not in _REGISTRY:
            raise KeyError(f"flag {name!r} is not registered")
        _REGISTRY[name] = _coerce(name, value)


# Core flags (subset of platform/flags.cc that is meaningful on TPU).
define_flag("check_nan_inf", False, "check every op output for NaN/Inf")
define_flag("benchmark", False, "synchronize after each op for timing")
define_flag("executor_cache_programs", True, "cache jitted program traces")
define_flag("use_bf16_matmul", True, "prefer bfloat16 matmul accumulation on MXU")
define_flag("eager_delete_tensor_gb", 0.0, "GC threshold (API parity; XLA manages memory)")
define_flag("tpu_profiler_port", 0, "jax.profiler server port (0 = off)")
define_flag("allocator_strategy", "xla", "API parity; XLA owns allocation on TPU")
define_flag("enable_unused_var_check", False, "warn on op inputs never read")
define_flag("static_analysis_preflight", False,
            "run the Program IR static analyzer (paddle_tpu.analysis) "
            "before every jit build; error diagnostics abort the run")
define_flag("collective_watchdog_ms", 0,
            "flag any collective in flight past this many ms (dump the "
            "flight recorder, report a stall to the elastic heartbeat "
            "plane); 0 disables the watchdog thread")
define_flag("flight_recorder_capacity", 4096,
            "events kept in the flight-recorder ring (most recent win)")
define_flag("obs_run_dir", "",
            "per-rank observability run directory (metrics snapshots, "
            "trace segments, flight dumps; merge with "
            "python -m paddle_tpu.tools.obs_report)")
define_flag("obs_history_dir", "",
            "durable CROSS-RUN perf-trajectory store (observability/"
            "history.py): finished runs append one flat record each to "
            "<dir>/history.jsonl — gate_view dims, serving p50/p99/qps, "
            "MTTR, SLO/action counts, bench validity + stall phase — "
            "read by python -m paddle_tpu.tools.trend_report and the "
            "obs_report history section; PADDLE_OBS_HISTORY_DIR env "
            "wins; empty disarms the store (appends become no-ops)")
define_flag("obs_history_max_mb", 16.0,
            "size cap of the history store's history.jsonl: when an "
            "append would push the file past this many MB it rotates "
            "to prev_history.jsonl first (the telemetry retention "
            "discipline, FLAGS_telemetry_max_mb); 0 disables rotation")
define_flag("obs_history_compact", 0,
            "opt-in post-rotation compaction of the rotated history "
            "generation: when > 1, prev_history.jsonl is downsampled "
            "in place to every Nth record — records with valid=false "
            "ALL survive (the stall-streak evidence) — bounding disk "
            "for a long-lived store; 0 (default) keeps rotated "
            "generations verbatim")
define_flag("obs_memory_sample_s", 30.0,
            "interval of the runlog's background device-memory sampler "
            "(allocator stats into the flight ring + metrics snapshot); "
            "0 disables the timer (per-snapshot sampling remains)")
define_flag("perf_chip_spec", "v5e",
            "chip the perf ledger's analytic MFU/roofline, the scaling "
            "projection AND the static per-device HBM byte-plan check "
            "(analysis.memory_plan, PTA406) run against: a known name "
            "(v5e/v5p/v6e/v4) or a JSON object {'peak_tflops':..,"
            "'hbm_gbps':..,'hbm_gb':..,'ici_gbps':..,'dcn_gbps':..,"
            "'alpha_us':..} (docs/perf.md)")
define_flag("perf_memory_analysis", True,
            "harvest compiled.memory_analysis() into the perf ledger "
            "(one extra XLA compile per unique executable; disable on "
            "latency-critical live-TPU paths — cost_analysis stays)")
define_flag("preempt_poll_s", 0.0,
            "poll the GCE metadata preemption endpoint every this many "
            "seconds and request a graceful preempt (checkpoint at the "
            "next step boundary) AHEAD of the SIGTERM notice; 0 "
            "disables the poller thread")
define_flag("serving_exec_cache_dir", "",
            "persistent compiled-executable cache for the serving "
            "plane (paddle_tpu.serving): fingerprint+bucket-keyed "
            "jax.export artifacts plus jax's compilation cache under "
            "<dir>/xla — a warm server boot compiles nothing "
            "(docs/serving.md). Empty disables persistence")
define_flag("serving_max_linger_ms", 2.0,
            "longest a continuous-batching worker waits for more "
            "requests while its bucket is underfull (never past the "
            "head request's deadline slack); 0 dispatches immediately")
define_flag("serving_default_deadline_ms", 0.0,
            "default per-request deadline for serving tenants that "
            "don't pass one explicitly; 0 means no deadline")
define_flag("serving_pipeline_depth", 2,
            "batches a tenant scheduler keeps in flight at once "
            "(pipelined dispatch): the worker pads/stages/dispatches "
            "batch k+1 while the device executes batch k and a "
            "readback stage completes futures off the dispatch loop; "
            "<= 1 restores the serial dispatch-block-complete loop "
            "(outputs are bit-identical either way; docs/serving.md)")
define_flag("serving_donate_inputs", True,
            "under a serving mesh (PredictorServer(mesh=...)), donate "
            "the device-staged input buffers to the executable where "
            "the artifact allows — staged feeds are fresh per batch "
            "and never reused, so XLA may reuse their memory for "
            "outputs; builds that refuse donation fall back silently")
define_flag("exec_cache_max_mb", 0.0,
            "size cap (MB) shared by the persistent executable caches "
            "(serving/cache.py and jit/exec_cache.py): storing past "
            "the cap evicts least-recently-USED .jaxexport entries "
            "(loads refresh recency) with cache/evictions counting "
            "them; 0 (default) never evicts")
define_flag("gateway_drain_timeout_s", 30.0,
            "graceful-drain budget of paddle_tpu.gateway.GatewayServer "
            "stop()/SIGTERM: stop accepting, then wait at most this "
            "long for in-flight requests to flush before returning "
            "(docs/gateway.md)")
define_flag("gateway_request_timeout_s", 60.0,
            "ceiling a gateway connection thread waits on one "
            "request's PredictionFuture before replying "
            "DEADLINE_EXCEEDED (a deadline-carrying request waits its "
            "own budget instead)")
define_flag("dp_exchange", "zero1",
            "data-parallel gradient-exchange decomposition for "
            "jit.DataParallelTrainStep: 'zero1' (default — "
            "reduce-scatter -> 1/N local optimizer-shard update -> "
            "all-gather; optimizer slots and fp32 masters sharded "
            "N-ways, arxiv 2004.13336) or 'allreduce' (the legacy "
            "fused bucketed all-reduce, bit-identical fallback). "
            "docs/comms.md")
define_flag("dp_comm_quantize", "",
            "quantized dp gradient transport (EQuARX-style, arxiv "
            "2506.17615): 'int8' or 'fp8' buckets with per-bucket "
            "scales and persistent error-feedback residuals; empty "
            "(default) ships full-precision buckets. zero1 mode only. "
            "On a two-level (outer, inner) mesh the composition is "
            "hierarchical: full-precision inner reduce-scatter, "
            "quantized OUTER shard exchange + fp32 scales (the slow "
            "domain is where the narrow payload pays most); the param "
            "all-gather always stays full precision (docs/comms.md)")
define_flag("dp_overlap", False,
            "overlapped zero1 gather schedule for "
            "jit.DataParallelTrainStep (arxiv 2004.13336 §pipelining): "
            "step N's param all-gather is double-buffered and issued "
            "at the top of step N+1 — hidden behind its forward — and "
            "the aux (loss/BN) sync is issued right after the forward "
            "— hidden behind the backward. Bit-identical to the "
            "serial schedule at identical accounted bytes; costs one "
            "extra 1/N param-dtype shard per bucket per device. Eager "
            "param reads between steps lag one update until "
            "state_dict()/sync_params() (docs/comms.md)")
define_flag("comm_schedule", "auto",
            "collective schedule on two-level (outer, inner) dp "
            "meshes: 'auto' (default — per-collective flat-ring vs 2D "
            "hierarchical choice from the fitted alpha/bw model, "
            "paddle_tpu.comms.schedule), 'flat', or 'hierarchical'")
define_flag("telemetry_interval_s", 0.0,
            "interval of the live-telemetry publisher thread: every "
            "this many seconds each rank appends a compact snapshot "
            "(counter/gauge deltas, histogram summaries, step cadence, "
            "in-flight collectives, device memory, per-tenant serving "
            "counters) to <rank>/telemetry.jsonl and pushes it to the "
            "monitor named by FLAGS_telemetry_endpoint / "
            "PADDLE_TELEMETRY_ENDPOINT; 0 (default) starts no thread "
            "(docs/observability.md)")
define_flag("telemetry_max_mb", 64.0,
            "size cap of a rank's telemetry.jsonl: when an append "
            "would push the file past this many MB it rotates to "
            "prev_telemetry.jsonl first (replacing any earlier "
            "rotation — the same prev_ discipline the runlog applies "
            "on rank-dir reuse), so a week-long run keeps at most "
            "~2x the cap on disk per rank; 0 disables rotation")
define_flag("telemetry_endpoint", "",
            "host:port of a paddle_tpu.observability.live."
            "MonitorService aggregator the telemetry publisher streams "
            "framed snapshots to (PADDLE_TELEMETRY_ENDPOINT env wins); "
            "empty keeps telemetry file-only")
define_flag("telemetry_stale_intervals", 3.0,
            "a rank is marked STALE by the monitor / obs_top after "
            "missing this many publish intervals (the rank_stale SLO "
            "rule's default threshold)")
define_flag("slo_rules", "",
            "declarative rolling-window SLO rules evaluated per "
            "telemetry snapshot (and cross-rank in the monitor), e.g. "
            "'step_time_p99_ms=250,window=60;error_rate=0.01'; a "
            "breach emits an slo flight event, slo/* counters, an "
            "agent-timeline line and flips the monitor /healthz "
            "(grammar: docs/observability.md). Empty disables the "
            "engine")
define_flag("obs_flush_every_line", True,
            "flush runlog jsonl sinks (steps.jsonl, telemetry.jsonl) "
            "after every record so live tailers (obs_top, a mid-run "
            "obs_report) never read a torn line; disable only for "
            "throughput micro-benchmarks of the runlog itself")
define_flag("action_policy", "",
            "declarative SLO-breach remediation policy (the action "
            "plane, paddle_tpu.observability.actions), e.g. "
            "'on=step_time_p99_ms do=restart_rank,cooldown=120,max=3;"
            "on=error_rate/tenantA do=shed_tenant,sustain=2' — the "
            "rank-side engine actuates dump/shed_tenant, an "
            "ElasticAgent(monitor_endpoint=...) actuates restart_rank/"
            "reshard_shrink from the monitor verdict; also readable "
            "from PADDLE_ACTION_POLICY (grammar: docs/observability.md"
            " 'Control loop'). Empty disables the engine")
define_flag("profile_steps", 8,
            "default step bound of an on-demand device-trace capture "
            "(observability.profiling.start_capture, do=profile, "
            "POST /profilez): the capture auto-stops after this many "
            "completed train steps; 0 leaves only the seconds "
            "deadline")
define_flag("profile_seconds", 30.0,
            "wall-clock backstop of an on-demand device-trace "
            "capture: auto-stop after this many seconds even if the "
            "step bound was never reached (a wedged run must not "
            "trace forever); 0 falls back to a 60s hard backstop")
define_flag("trainstep_cache_dir", "",
            "persistent compiled-executable cache for jit.TrainStep "
            "(paddle_tpu.jit.exec_cache): the first compile exports "
            "the train step keyed (program fingerprint, mesh, "
            "donation signature) and primes jax's compilation cache "
            "under <dir>/xla, so a relaunched gang (elastic restart) "
            "warm-boots with ZERO python traces — restarts cheap "
            "enough to be policy; also readable from "
            "PADDLE_TRAINSTEP_CACHE_DIR. Empty disables persistence")
define_flag("telemetry_compact", 0,
            "opt-in post-rotation compaction of rotated telemetry "
            "generations (tools/obs_compact): when > 1, a freshly "
            "rotated prev_telemetry.jsonl is downsampled in place to "
            "every Nth snapshot plus ALL breach/action/final lines — "
            "multi-day retention at bounded disk; 0 (default) keeps "
            "rotated generations verbatim")
define_flag("fault_spec", "",
            "deterministic fault-injection spec (chaos testing), e.g. "
            "'crash@step=7,rank=1;hang@collective=all_reduce,seq=12'; "
            "also readable from PADDLE_FAULT_SPEC (grammar: "
            "docs/fault_tolerance.md). Empty disables every hook")

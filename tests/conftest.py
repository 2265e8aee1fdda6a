def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "smoke: fast fleet-engine smoke tests (seconds, not minutes)")
    config.addinivalue_line(
        "markers",
        "serving: continuous-batching server + property suites (tier-1 runs "
        "them at small example counts; scale up via ASC_TEST_EXAMPLES)")
    config.addinivalue_line(
        "markers",
        "trace: syscall tracing + policy subsystem suites (traced/untraced "
        "bit-exact parity, ring overflow, seccomp-style actions; scale up "
        "via ASC_TEST_EXAMPLES)")
    config.addinivalue_line(
        "markers",
        "compaction: live-lane compaction suites (compacted vs fixed-width "
        "bit-exact lane-ordered parity across mechanism x workload x chunk "
        "x ladder rung, trace rings through shrink/re-expansion, FleetServer "
        "C3 re-admission into a compacted pool; scale up via "
        "ASC_TEST_EXAMPLES)")
    config.addinivalue_line(
        "markers",
        "sched: policy scheduler suites (default-scheduler vs unscheduled "
        "bit-exact equivalence traced/untraced x compact on/off, "
        "preempt/evict/budget checkpoints resume bit-identically, live "
        "update_policy with bit-identical bystanders, quarantine backoff; "
        "scale up via ASC_TEST_EXAMPLES)")
    config.addinivalue_line(
        "markers",
        "stream: streaming trace pipeline suites (zero-drop property across "
        "mechanism x workload x chunk x compaction, flip-boundary "
        "bit-identity, TraceStream reassembly/writers/follow ordering, "
        "on-device histogram correctness; scale up via ASC_TEST_EXAMPLES)")
    config.addinivalue_line(
        "markers",
        "durability: durable-serving suites (write-ahead journal torn-tail "
        "semantics, kill-at-any-generation recovery bit-identity across "
        "sched+trace+compact, chaos fault injection answered by "
        "retry/rollback/quarantine/shed, snapshot corruption fallback; "
        "scale up via ASC_TEST_EXAMPLES)")
    config.addinivalue_line(
        "markers",
        "megastep: Pallas megastep engine suites (pallas==xla==scalar "
        "bit-exact parity across mechanism x workload x chunk x "
        "compaction on/off, traced carries included, interpret-mode on "
        "forced-host devices; scale up via ASC_TEST_EXAMPLES)")
    config.addinivalue_line(
        "markers",
        "emul: guest-kernel emulation suites (per-lane fd tables + in-memory "
        "filesystem semantics, errno paths, scalar==xla==pallas bit-exact "
        "parity, kernel carry through compaction/preemption/kill-and-recover, "
        "legacy stub equivalence with emul_enabled=False)")
    config.addinivalue_line(
        "markers",
        "obs: serving telemetry suites (registry/profiler/span units, "
        "observed-vs-unobserved bit-identity, zero-allocation disabled "
        "path, obs knob round-trip + sink validation, resume-wait ledger, "
        "ledger gauges, counters monotone + spans complete across "
        "kill-and-recover; scale up via ASC_TEST_EXAMPLES)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips without one (the PyTorch port's "
        "kernel-vs-plain tests, run on the card with "
        "`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`)")

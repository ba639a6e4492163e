#!/usr/bin/env python3
"""Times the port's SCU barrier kernel (K3), and K4 and K5, on the card.

    PYTHONPATH=src python3 scripts/bench_scu_barrier.py [--parties 2 8 64 128 1024] [--repeats 3]
        [--sweep-parties 8]

Needs an NVIDIA GPU and ``nvcc``.  Sections, in order:

1. K3's forms on this card: the cluster form's party limit (8, or 16 where
   the non-portable size is taken) and row cap, and the dissemination
   form's resident limit.
2. Host breakdown: ``time.perf_counter_ns`` around each statement of a K3
   call at n = 8 and a K5 call at 8 floats, 10,000 calls, for the earlier
   wrappers (with a device context, ``Stream`` objects and reshapes; their
   statements replayed) and the current ones, beside the whole call and the
   library call.
3. Latency floors, each repeated to show its spread: a one-way flag
   hand-off between two SMs (a two-CTA ping-pong that waits as the
   dissemination form waits, ``scu_pingpong``), an empty cooperative launch
   of ``n`` one-warp CTAs (``scu_empty``), and a cluster launch of ``n``
   CTAs, empty and with one ``cluster.sync()`` (``scu_cluster_floor``).
4. K3 a call at each ``n`` (and at the largest resident group) in the form
   it takes, in turns with one PyTorch call for the same function (a sum
   over the party axis, expanded), beside its plain version and its floor;
   K5 a call at 8 floats in turns with ``x + 1``.  These are back-to-back
   calls timed with CUDA events: where a call costs the host more than the
   card, they are host times.
5. The card's own time of a launch (``torch.profiler``): K3 in each form it
   can take at n = 2, 8, 64, 1024 and the resident limit, K4, and K5 at 8
   floats and 2^20.
6. One pass of the barrier sweep (``repro_torch.launch.barriers``) under the
   profiler at regions 1 and 64 under every policy: the card's busy time,
   the wall time and the idle share.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.compat import card_name_and_power_limit
from repro_torch.kernels._build import rows_aligned
from repro_torch.kernels.scu_barrier import kernel as scu
from repro_torch.kernels.scu_barrier.ref import barrier_ref
from repro_torch.launch import barriers
from repro_torch.sync import available_policies, get_policy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import time_ms  # noqa: E402


def traced(fn, iters: int):
    """Runs ``fn`` ``iters`` times under the profiler; returns (wall s, {kernel name: (launches, device us)})."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}  # fmt: skip
    return wall, kernels


def device_us_per_launch(fn, name: str, iters: int = 500) -> float:
    """Mean device time of one launch of the kernel whose name contains ``name``."""
    _, kernels = traced(fn, iters)
    hits = [(c, t) for key, (c, t) in kernels.items() if name in key]
    if not hits:
        raise SystemExit(f"the profiler saw no kernel named like {name!r}: {sorted(kernels)}")
    return sum(t for _, t in hits) / sum(c for c, _ in hits)


def steps_ns(steps, iters: int) -> list:
    """Runs ``steps`` (``(label, fn(state))`` in order) ``iters`` times, with
    ``time.perf_counter_ns`` around each; returns (label, mean ns) per step."""
    clock = time.perf_counter_ns
    totals = [0] * len(steps)
    for _ in range(iters):
        state = {}
        for k, (_, fn) in enumerate(steps):
            t0 = clock()
            fn(state)
            totals[k] += clock() - t0
    torch.cuda.synchronize()
    return [(label, total / iters) for (label, _), total in zip(steps, totals)]


def earlier_barrier_steps(arrive: torch.Tensor) -> list:
    """The statements of the earlier ``scu_barrier`` wrapper, which entered a
    ``torch.cuda.device`` context, queried ``current_stream()`` twice and
    reshaped its input and output, one step each, replayed on the current
    library (whose launch entry also takes the device index).  That wrapper
    had only the dissemination form."""
    lib = scu.build()

    def enter(st):
        st["ctx"] = torch.cuda.device(st["device"])
        st["ctx"].__enter__()

    def take(st):
        ws, device = st["ws"], st["device"]
        _ = ws.flags.device != device, ws.words.device != device  # the earlier workspace compared devices
        st["flags"], st["words"], st["epoch"] = ws.take(3 * st["n"], st["n"] * st["m"])

    def launch(st):
        st["err"] = lib.scu_barrier(st["rows"].data_ptr(), st["out"].data_ptr(), st["words"].data_ptr(),
                                    st["flags"].data_ptr(), st["n"], st["m"], st["epoch"],
                                    scu.SPIN_LIMIT_CYCLES, st["device"].index, st["stream"])  # fmt: skip

    return [
        ("checks + reshape().contiguous()", lambda st: st.update(
            rows=scu._party_rows(arrive, "scu_barrier").reshape(arrive.shape[0], -1).contiguous())),
        ("n, m = shape; .device", lambda st: st.update(n=st["rows"].shape[0], m=st["rows"].shape[1],
                                                       device=st["rows"].device)),
        ("max_parties(index)", lambda st: scu.max_parties(st["device"].index)),
        ("workspace key with current_stream(device) + lookup", lambda st: st.update(ws=scu._workspace(
            "barrier", st["device"].index, torch.cuda.current_stream(st["device"]).cuda_stream))),
        ("workspace.take with device comparisons", take),
        ("torch.empty_like", lambda st: st.update(out=torch.empty_like(st["rows"]))),
        ("build()", lambda st: scu.build()),
        ("with torch.cuda.device: enter", enter),
        ("current_stream().cuda_stream", lambda st: st.update(stream=torch.cuda.current_stream().cuda_stream)),
        ("ctypes call + launch (dissemination form)", launch),
        ("with torch.cuda.device: exit", lambda st: st["ctx"].__exit__(None, None, None)),
        ("_check", lambda st: scu._check(lib, "scu_barrier", st["err"])),
        ("out.reshape", lambda st: st["out"].reshape(arrive.shape)),
    ]  # fmt: skip


def current_barrier_steps(arrive: torch.Tensor) -> list:
    """The statements of the current ``scu_barrier`` wrapper at n = 8 (cluster form), one step each."""
    lib = scu.build()

    def launch(st):
        st["err"] = lib.scu_barrier_cluster(st["rows"].data_ptr(), st["out"].data_ptr(), st["n"], st["m"],
                                            st["index"], st["stream"])  # fmt: skip

    return [
        ("checks; contiguous() only where not", lambda st: st.update(rows=scu._party_rows(arrive, "scu_barrier"))),
        ("n, m; get_device()", lambda st: st.update(n=st["rows"].shape[0], m=st["rows"].numel() // st["rows"].shape[0],
                                                    index=st["rows"].get_device())),
        ("raw stream", lambda st: st.update(stream=scu._stream(st["index"]))),
        ("build()", lambda st: scu.build()),
        ("barrier_form(n, m, *cluster_limit(index))",
         lambda st: scu.barrier_form(st["n"], st["m"], *scu.cluster_limit(st["index"]))),
        ("torch.empty_like", lambda st: st.update(out=torch.empty_like(st["rows"]))),
        ("ctypes call + launch (cluster form)", launch),
        ("_check", lambda st: scu._check(lib, "scu_barrier", st["err"])),
    ]  # fmt: skip


def earlier_signal_steps(x: torch.Tensor) -> list:
    """The statements of the earlier ``scu_self_signal`` wrapper (a device
    context, ``current_stream()``, reshapes), one step each, replayed on the
    current library (whose entry also takes the device index)."""
    lib = scu.build()

    def enter(st):
        st["ctx"] = torch.cuda.device(x.device)
        st["ctx"].__enter__()

    return [
        ("checks (is_cuda, dtype, numel)", lambda st: (x.is_cuda, x.dtype != torch.float32, x.numel() == 0)),
        ("x.reshape(-1)", lambda st: st.update(flat=x.reshape(-1))),
        ("rows_aligned", lambda st: rows_aligned(st["flat"])),
        ("torch.empty_like", lambda st: st.update(out=torch.empty_like(st["flat"]))),
        ("build()", lambda st: scu.build()),
        ("with torch.cuda.device: enter", enter),
        ("ctypes call + launch (current_stream() in the call)", lambda st: st.update(
            err=lib.scu_self_signal(st["flat"].data_ptr(), st["out"].data_ptr(), st["flat"].numel(),
                                    x.device.index, torch.cuda.current_stream().cuda_stream))),
        ("with torch.cuda.device: exit", lambda st: st["ctx"].__exit__(None, None, None)),
        ("_check", lambda st: scu._check(lib, "scu_self_signal", st["err"])),
        ("out.reshape", lambda st: st["out"].reshape(x.shape)),
    ]  # fmt: skip


def current_signal_steps(x: torch.Tensor) -> list:
    """The statements of the current ``scu_self_signal`` wrapper, one step each."""
    lib = scu.build()
    return [
        ("checks (is_cuda, dtype, numel)", lambda st: (x.is_cuda, x.dtype != torch.float32, x.numel() == 0)),
        ("is_contiguous() and 16-byte start", lambda st: x.is_contiguous() and x.data_ptr() % 16 == 0),
        ("get_device()", lambda st: st.update(index=x.get_device())),
        ("torch.empty_like", lambda st: st.update(out=torch.empty_like(x))),
        ("build()", lambda st: scu.build()),
        ("ctypes call + launch (raw stream in the call)", lambda st: st.update(
            err=lib.scu_self_signal(x.data_ptr(), st["out"].data_ptr(), x.numel(), st["index"],
                                    scu._stream(st["index"])))),
        ("_check", lambda st: scu._check(lib, "scu_self_signal", st["err"])),
    ]  # fmt: skip


def host_breakdown(iters: int = 10_000) -> None:
    """Host time of each statement of a K3 call at n = 8 and a K5 call at 8
    floats, the earlier wrappers (replayed) and the current ones, beside the whole call
    and the library call, each over ``iters`` calls back to back (host
    clock, no synchronize inside)."""
    arrive = torch.ones(8, device="cuda")
    x = torch.zeros(8, device="cuda")
    empty = steps_ns([("", lambda st: None)], iters)[0][1]
    print(f"host breakdown, {iters} calls, time.perf_counter_ns around each step; an empty step "
          f"costs {empty:.0f} ns (timer + call), not subtracted below")
    cases = [
        ("K3 scu_barrier n=8, the earlier wrapper's statements", earlier_barrier_steps(arrive), None, None),
        ("K3 scu_barrier n=8, the current wrapper's statements", current_barrier_steps(arrive), lambda: scu.scu_barrier(arrive),
         ("library sum + expand", lambda: arrive.sum(0, keepdim=True).expand_as(arrive))),
        ("K5 scu_self_signal 8 floats, the earlier wrapper's statements", earlier_signal_steps(x), None, None),
        ("K5 scu_self_signal 8 floats, the current wrapper's statements", current_signal_steps(x), lambda: scu.scu_self_signal(x),
         ("library x + 1", lambda: x + 1)),
    ]  # fmt: skip
    for title, steps, call, library in cases:
        pieces = steps_ns(steps, iters)
        line = f"  {title}: sum of steps {sum(ns for _, ns in pieces) / 1e3:.2f} us"
        if call is not None:
            whole = steps_ns([("", lambda st: call())], iters)[0][1]
            lib_ns = steps_ns([("", lambda st: library[1]())], iters)[0][1]
            line += f"; the wrapper called whole {whole / 1e3:.2f} us; {library[0]} {lib_ns / 1e3:.2f} us (host, a call)"
        print(line)
        for label, ns in pieces:
            print(f"    {ns / 1e3:7.2f} us  {label}")


def floors(repeats: int, parties: list, cluster_parties: int) -> float:
    """The latency floors, each repeated to show its spread; returns the
    shortest one-way hand-off (ms)."""
    handoffs = [scu.handoff_ms() for _ in range(repeats)]
    print("one-way hand-off between two SMs (ping-pong of 20,000 round trips): "
          + ", ".join(f"{h * 1e3:.3f}" for h in handoffs) + " us")
    for n in parties:
        print(f"empty cooperative launch of {n} one-warp CTAs, back to back: "
              + ", ".join(f"{scu.launch_ms(n) * 1e3:.2f}" for _ in range(repeats)) + " us")
    for n in sorted({2, 8, cluster_parties} - {0}):
        empty = [scu.cluster_floor_ms(n, 0) for _ in range(repeats)]
        synced = [scu.cluster_floor_ms(n, 1) for _ in range(repeats)]
        print(f"cluster of {n} one-warp CTAs, back to back: empty " + ", ".join(f"{t * 1e3:.2f}" for t in empty)
              + " us; one cluster.sync() " + ", ".join(f"{t * 1e3:.2f}" for t in synced) + " us")
    return min(handoffs)


def launch_in(form: str, arrive: torch.Tensor) -> None:
    """One K3 launch of ``arrive`` (n,) in ``form``, past ``barrier_form``:
    measurement only, to time both forms at the same n."""
    lib = scu.build()
    n, stream = arrive.shape[0], scu._stream(0)
    out = torch.empty_like(arrive)
    if form == "cluster":
        err = lib.scu_barrier_cluster(arrive.data_ptr(), out.data_ptr(), n, 1, 0, stream)
    else:
        flags, words, epoch = scu._workspace("bench", 0, stream).take(max(1, (n - 1).bit_length() * n), n)
        err = lib.scu_barrier(arrive.data_ptr(), out.data_ptr(), words.data_ptr(), flags.data_ptr(), n, 1,
                              epoch, scu.SPIN_LIMIT_CYCLES, 0, stream)  # fmt: skip
    scu._check(lib, f"scu_barrier ({form} form)", err)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parties", type=int, nargs="+", default=[2, 8, 64, 128, 1024])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sweep-parties", type=int, default=8)
    args = ap.parse_args()

    print(card_name_and_power_limit())
    scu.build()
    most = scu.max_parties(0)
    cluster_parties, row_cap = scu.cluster_limit(0)
    print(f"K3 forms on this card: cluster for n <= {cluster_parties} "
          f"({'non-portable size taken' if cluster_parties > 8 else 'portable size'}) with rows of at most "
          f"{row_cap} words; dissemination up to n = {most} (the resident limit)")
    host_breakdown()
    handoff = floors(args.repeats, args.parties, cluster_parties)
    for n in args.parties + [most]:
        form = scu.barrier_form(n, 1, cluster_parties, row_cap)
        rounds = (n - 1).bit_length()
        arrive = torch.randint(0, 50, (n,), device="cuda").float()
        if not torch.equal(scu.scu_barrier(arrive), barrier_ref(arrive)):
            raise SystemExit(f"scu_barrier disagrees with barrier_ref at n={n}")
        # in turns: library, kernel, kernel, kernel, library
        library = [time_ms(lambda: arrive.sum(0, keepdim=True).expand_as(arrive), iters=2000, warmup=20)]
        kernel = [time_ms(lambda: scu.scu_barrier(arrive), iters=2000, warmup=20) for _ in range(args.repeats)]
        library.append(time_ms(lambda: arrive.sum(0, keepdim=True).expand_as(arrive), iters=2000, warmup=20))
        plain = time_ms(lambda: barrier_ref(arrive), iters=2000, warmup=20)
        kernel_med, library_med = sorted(kernel)[len(kernel) // 2], sum(library) / len(library)
        floor = (scu.cluster_floor_ms(n, 2) if form == "cluster"
                 else rounds * handoff + scu.launch_ms(n))  # fmt: skip
        print(f"K3 n={n:5d} ({form}): kernel " + ", ".join(f"{k * 1e3:.2f}" for k in kernel)
              + " us a call; library (sum + expand) " + ", ".join(f"{x * 1e3:.2f}" for x in library)
              + f" us; kernel / library {kernel_med / library_med:.2f}x; plain {plain * 1e3:.2f} us; floor "
              + f"{floor * 1e3:.2f} us ("
              + ("a cluster launch with two cluster.sync()" if form == "cluster"
                 else f"{rounds} hand-offs of {handoff * 1e3:.3f} us + one empty cooperative launch") + ")")
    x = torch.zeros(8, device="cuda")
    library = [time_ms(lambda: x + 1, iters=2000, warmup=20)]
    kernel = [time_ms(lambda: scu.scu_self_signal(x), iters=2000, warmup=20) for _ in range(args.repeats)]
    library.append(time_ms(lambda: x + 1, iters=2000, warmup=20))
    print("K5 8 floats: kernel " + ", ".join(f"{k * 1e3:.2f}" for k in kernel) + " us a call; library (x + 1) "
          + ", ".join(f"{t * 1e3:.2f}" for t in library) + " us; kernel / library "
          + f"{sorted(kernel)[len(kernel) // 2] / (sum(library) / len(library)):.2f}x")
    device_times(args.sweep_parties, cluster_parties, most)
    sweep_idle_share(args.sweep_parties)


def device_times(sweep_parties: int, cluster_parties: int, most: int) -> None:
    """The card's own time of a launch (profiler): K3 in each form it can
    take at n = 2, 8, 64, 1024 and the resident limit, one word a party; K4;
    K5 at 8 floats and at 2^20."""
    for n in (2, 8, 64, 1024, most):
        arrive = torch.ones(n, device="cuda")
        forms = (["cluster"] if n <= cluster_parties else []) + ["dissemination"]
        print(f"K3 n={n}: device " + "; ".join(
            f"{form} {device_us_per_launch(lambda: launch_in(form, arrive), name):.2f} us a launch"
            for form, name in ((f, "barrier_cluster_kernel" if f == "cluster" else "barrier_kernel") for f in forms)))
    n = sweep_parties
    counts = torch.ones(n, 1, device="cuda")
    small, big = torch.zeros(n, device="cuda"), torch.zeros(2**20, device="cuda")
    cases = [
        ("scu_notifier", f"n={n}", "notifier_kernel", lambda: scu.scu_notifier(counts, 0)),
        ("scu_self_signal", f"{n} floats", "self_signal_kernel", lambda: scu.scu_self_signal(small)),
        ("scu_self_signal", "2^20 floats", "self_signal_kernel", lambda: scu.scu_self_signal(big)),
    ]  # fmt: skip
    for name, shape, kernel, fn in cases:
        dev = device_us_per_launch(fn, kernel)
        host = time_ms(fn, iters=500, warmup=5) * 1e3
        print(f"{name} at {shape}: device {dev:.2f} us a launch (profiler); a call back to back {host:.2f} us "
              "(CUDA events)")


def sweep_idle_share(parties: int) -> None:
    """One pass of the barrier sweep under the profiler, per policy and region."""
    x = torch.ones((parties, 8, barriers.DIM), device="cuda")
    a = torch.eye(barriers.DIM, device="cuda") * 0.99
    arrive = torch.ones(parties, device="cuda")
    for region in (1, 64):
        for name in available_policies():
            policy = get_policy(name)
            wall, kernels = traced(lambda: barriers.barrier_pass(x, a, region, barriers.N_BARRIERS, policy, arrive), 3)
            busy = sum(t for _, t in kernels.values()) / 1e6
            launches = sum(c for c, _ in kernels.values()) / 3
            print(f"sweep n={parties} region {region:2d} {name:8s}: wall {wall / 3 * 1e3:.3f} ms a pass, "
                  f"device busy {busy / 3 * 1e3:.3f} ms, idle share {1 - busy / wall:.3f}, "
                  f"{launches:.0f} kernels a pass")


if __name__ == "__main__":
    main()

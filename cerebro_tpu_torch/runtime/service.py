"""Live service: continuous background processing around the pipeline
(counterpart of cerebro_tpu/runtime/service.py).

The operational form of the reference's ``cerebro_node`` process (main()
spawns threads and ros::spin()s, ref src/cerebro_node.cpp:430-530):
producers push camera/VIO feeds from any thread; one background worker
drains the native association engine, runs batched description and
detection, verifies candidates at a 1 Hz cadence, and a second thread
re-solves the pose graph every 10 s. Engine state stays single-writer (the
worker); producers only touch the native engine's locked queues and the
locked pixel buffers.

Shutdown mirrors the reference's teardown (disable flags -> join -> save
state, ref :533-568): ``stop()`` joins both threads, re-raises an exception
either of them died of, drains the remaining work, and an optional
``save_dir`` checkpoints the map for teach and repeat.

Both threads share the interpreter lock and the CUDA device's default
stream. ``status()`` reads host counters only (the pipeline's timer
counters among them: ``verify_queue``, ``undrained_batches``), so a
monitoring thread may call it without waiting on the device.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline, StreamIngestor


class CerebroService:
    def __init__(
        self,
        pipeline: CerebroPipeline,
        verify_every_s: float = 1.0,  # ref consumer thread at 1 Hz
        optimize_every_s: float = 10.0,
        hold_s: float = 0.2,
        idle_sleep_s: float = 0.01,
        ingest_capacity: int = 4096,  # frame-queue bound; past it pushes are rejected
        flush_interval_s: float = 0.4,  # max descriptor latency before a
        # partial-batch describe (full batches describe at once inside
        # ingest_frame); without it the worker would describe a padded
        # batch per frame
    ):
        self.pipeline = pipeline
        self.ingest = StreamIngestor(pipeline, hold_s=hold_s, capacity=ingest_capacity)
        self.verify_every_s = verify_every_s
        self.optimize_every_s = optimize_every_s
        self.idle_sleep_s = idle_sleep_s
        self.flush_interval_s = flush_interval_s
        self._worker: Optional[threading.Thread] = None
        self._optimizer: Optional[threading.Thread] = None
        self._running = threading.Event()
        self.latest_trajectory = None
        self._error: Optional[BaseException] = None

    # -- producer API (any thread): delegate to the ingestor --------------

    def push_image(self, stamp_ns, img, is_right=False):
        self.ingest.push_image(stamp_ns, img, is_right)

    def push_pose(self, stamp_ns, w_T_c):
        self.ingest.push_pose(stamp_ns, w_T_c)

    def push_tracking(self, stamp_ns, n_tracked, is_keyframe=True):
        self.ingest.push_tracking(stamp_ns, n_tracked, is_keyframe)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._worker is not None:
            raise RuntimeError("the service is already started")
        self._running.set()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        # The pose graph re-solves on its own thread, as the reference's
        # solver is a separate process (solve_keyframe_pose_graph, ref
        # README.md:176-194) that never blocks cerebro_node. It only READS
        # worker state (store rows below the size watermark, the
        # append-only loop_edges list) and writes latest_trajectory.
        self._optimizer = threading.Thread(target=self._run_optimizer, daemon=True)
        self._optimizer.start()

    def stop(self, save_dir: Optional[str] = None, timeout: float = 60.0):
        """Join the threads, re-raise an exception either died of, drain the
        remaining work on the caller's thread, and optionally checkpoint
        (ref teardown + saveStateToDisk, src/cerebro_node.cpp:533-568)."""
        self._running.clear()
        for name in ("_worker", "_optimizer"):
            thread = getattr(self, name)
            if thread is not None:
                thread.join(timeout=timeout)
                if thread.is_alive():
                    raise RuntimeError(f"the service's {name[1:]} thread did not stop in {timeout} s")
                setattr(self, name, None)
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        # loop until the engine is dry (one pump takes at most 256 frames)
        while self.ingest.pump() > 0:
            pass
        self.pipeline.flush_descriptors()
        if self.pipeline.rig is not None:
            self.pipeline.verify_pending(device_batch=8)
        self.latest_trajectory = self.pipeline.optimize_trajectory()
        if save_dir is not None:
            from cerebro_tpu_torch.io import save_pipeline_state

            save_pipeline_state(self.pipeline, save_dir)

    def status(self) -> dict:
        s = self.pipeline.status()
        s["service_running"] = self._running.is_set()
        s["ingest_pending"] = int(self.ingest.engine.pending)
        s["ingest_dropped"] = int(self.ingest.engine.dropped)
        s["pixels_dropped"] = self.ingest.pixels_dropped
        s["pixel_buffers"] = len(self.ingest._left) + len(self.ingest._right)
        return s

    # -- worker ------------------------------------------------------------

    def _tick(self, state: dict) -> int:
        """One worker-loop step: pump -> flush -> (1 Hz) verify.

        Verification runs inline at the consumer cadence (ref 1 Hz
        loopcandidate consumer, src/Cerebro.cpp:1203): one bounded group of
        at most 8 pairs per due tick, sequenced with ingestion so verify
        and describe never contend for the device. The live tier skips the
        cascade's gather-bank escalation (cascade=False); the end-of-run
        drain escalates as configured. The candidate queue lags under a
        burst, as the reference's consumer does."""
        pipe = self.pipeline
        B = pipe.cfg.runtime.descriptor_batch
        t_tick = time.perf_counter()
        with pipe.timer.stage("pump"):
            fed = self.ingest.pump()
        now = time.monotonic()
        # full batches describe inside ingest_frame; a partial batch only
        # once it ages past the latency bound
        pending = len(pipe._pending_desc)
        if pending >= B or (pending > 0 and now - state["last_flush"] >= self.flush_interval_s):
            pipe.flush_descriptors()
            state["last_flush"] = now
        # Detection results are read back at a bounded cadence, not every
        # iteration: the read waits on all queued device work.
        if pipe.rig is not None and now - state.get("last_drain", 0.0) >= min(self.verify_every_s, 0.25):
            state["last_drain"] = now
            if now - state["last_verify"] >= self.verify_every_s and pipe.candidates:
                with pipe.timer.stage("verify_live"):
                    pipe.verify_pending(max_pairs=8, device_batch=8, cascade=False)
                # after the call: duty <= verify / (verify + verify_every_s)
                state["last_verify"] = time.monotonic()
        pipe.timer.record("tick", time.perf_counter() - t_tick)
        return fed

    def _run(self):
        state = {"last_flush": time.monotonic(), "last_verify": 0.0}
        try:
            while self._running.is_set():
                if self._tick(state) == 0:
                    time.sleep(self.idle_sleep_s)
        except BaseException as e:  # re-raised by stop()
            self._error = e
            self._running.clear()

    def run_inline(self, until, optimize: bool = True):
        """Run the worker loop on the calling thread until ``until()``
        returns True, folding in the optimizer's cadence. Producers still
        push from their own threads. It replaces ``start()``: do not call
        both."""
        if self._worker is not None:
            raise RuntimeError("run_inline replaces the worker thread; the service is started")
        state = {"last_flush": time.monotonic(), "last_verify": 0.0}
        last_opt = 0.0
        n_edges_opt = 0
        while not until():
            fed = self._tick(state)
            now = time.monotonic()
            n = len(self.pipeline.loop_edges)
            if optimize and n and n != n_edges_opt and now - last_opt >= self.optimize_every_s:
                self.latest_trajectory = self.pipeline.optimize_trajectory()
                last_opt = now
                n_edges_opt = n
            if fed == 0:
                time.sleep(self.idle_sleep_s)

    def _run_optimizer(self):
        last_n_edges = 0
        try:
            while self._running.is_set():
                # sleep in small steps so stop() joins promptly
                deadline = time.monotonic() + self.optimize_every_s
                while self._running.is_set() and time.monotonic() < deadline:
                    time.sleep(min(0.05, self.idle_sleep_s * 5))
                n = len(self.pipeline.loop_edges)
                if n and n != last_n_edges:
                    self.latest_trajectory = self.pipeline.optimize_trajectory()
                    last_n_edges = n
        except BaseException as e:  # re-raised by stop()
            self._error = e
            self._running.clear()

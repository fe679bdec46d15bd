"""Instrumented bench: per-chunk wall time + mapping job timing."""
import time, numpy as np, jax
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import bench as B

make_system, imgs, deps, seq = B.build()

sys_ = make_system()
B.run(sys_, imgs, deps)  # warmup
sys_.warm_mapping()      # precompile BOTH mapping buckets + loop programs
                         # (bench.py's official path does the same)

sys_ = make_system()
tr = sys_.tracker
mp = sys_.mapping_pipeline

# wrap the pipeline submit/wait/poll for timing
orig_submit, orig_wait, orig_poll = mp.submit, mp.wait, mp.poll
job_times, wait_times = [], []
def submit(m, kf_id):
    t0 = time.perf_counter()
    orig_submit(m, kf_id)
    job_times.append(["submit", kf_id, time.perf_counter() - t0])
def wait(timeout=None):
    t0 = time.perf_counter()
    r = orig_wait(timeout=timeout)
    wait_times.append(time.perf_counter() - t0)
    return r
mp.submit, mp.wait = submit, wait

# wrap worker job to time it
orig_lm = mp.local_mapper.process_keyframe
lm_times = []
def lm_pk(m, kf, **kw):
    t0 = time.perf_counter()
    r = orig_lm(m, kf, **kw)
    lm_times.append(time.perf_counter() - t0)  # enqueue-only time
    return r
mp.local_mapper.process_keyframe = lm_pk
orig_lc = mp.loop_closer.process_keyframe
lc_times = []
def lc_pk(m, kf, abort=None):
    t0 = time.perf_counter()
    r = orig_lc(m, kf, abort=abort)
    lc_times.append(time.perf_counter() - t0)
    return r
mp.loop_closer.process_keyframe = lc_pk

chunk_times = []
orig_dispatch = tr._dispatch_chunk
def dispatch(sensor):
    t0 = time.perf_counter()
    orig_dispatch(sensor)
    chunk_times.append(time.perf_counter() - t0)
tr._dispatch_chunk = dispatch

t0 = time.perf_counter()
B.run(sys_, imgs, deps)
total = time.perf_counter() - t0
print(f"total: {total:.2f}s  fps={len(imgs)/total:.1f}")
print(f"chunks: {len(chunk_times)}  sum={sum(chunk_times):.2f}s  each={[round(t*1000) for t in chunk_times]}")
print("lc metrics:", {k: v for k, v in mp.loop_closer.metrics.items() if not isinstance(v, list)})
print(f"waits: {len(wait_times)}  sum={sum(wait_times):.2f}s  each={[round(t*1000) for t in wait_times]}")
print(f"lm enqueue: n={len(lm_times)} sum={sum(lm_times):.2f}s")
print(f"lc host: n={len(lc_times)} sum={sum(lc_times):.2f}s each={[round(t*1000) for t in lc_times]}")
print(f"jobs: {mp.jobs_run}")

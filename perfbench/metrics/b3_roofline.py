"""B3, the chunk-history attention of long-prompt admission: its least time
at the traced segment's shapes (roofline.chunk_call for each chunk after the
first of each chunked admission, every PQ layer of the architecture;
operations at the bf16 tensor-core rate where its tensor-core version ran,
else f32) over its traced time (%)."""

from perfbench import roofline

KERNELS = r"pq_chunk_attention"


def read(run):
    if run.trace is None:
        return None
    spent, _ = run.trace.kernel_s(KERNELS)
    _, mma = run.trace.kernel_s(r"pq_chunk_attention_mma")
    rate = roofline.BF16_OPS_PER_S if mma else roofline.F32_OPS_PER_S
    m, pq = run.config, run.config["pq"]
    G = m["num_attention_heads"] // m["num_key_value_heads"]
    layers = len(run.plain.pq_layers(m))
    bound = 0.0
    for s in run.phase_steps("trace"):
        for a in s.calls.admissions:
            if a.chunk is None:
                continue
            n_pad = -(-max(a.lens) // a.chunk) * a.chunk
            for s0 in range(a.chunk, n_pad, a.chunk):
                nbytes, ops = roofline.chunk_call(len(a.lens), a.chunk * G, s0, nh_k=m["num_key_value_heads"],
                                                  d=m["head_dim"], M=m["head_dim"] // pq["d_m"], O=pq["outliers"])
                bound += layers * roofline.bound_s(nbytes, ops, rate)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None

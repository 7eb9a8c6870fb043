"""B4, the paged PQ decode attention: its least time at the traced
segment's shapes (roofline.paged_call for each live slot, every PQ layer
of the architecture in every tick; operations at the f32 rate) over its
traced time (%)."""

from perfbench import roofline

KERNELS = r"pq_(score|value|reduce)_kernel"


def read(run):
    if run.trace is None:
        return None
    spent, _ = run.trace.kernel_s(KERNELS)
    m, pq = run.config, run.config["pq"]
    G = m["num_attention_heads"] // m["num_key_value_heads"]
    layers = len(run.plain.pq_layers(m))
    bound = 0.0
    for s in run.phase_steps("trace"):
        for t in s.calls.ticks:
            nbytes, ops = roofline.paged_call(t.codes, t.rows, nh_k=m["num_key_value_heads"], G=G,
                                              d=m["head_dim"], M=m["head_dim"] // pq["d_m"], C=pq["C"],
                                              O=pq["outliers"])
            bound += layers * roofline.bound_s(nbytes, ops, roofline.F32_OPS_PER_S)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None

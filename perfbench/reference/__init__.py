"""The plain reference: the served model and its quantized cache, in plain
PyTorch, importing nothing of the program.

reference/<architecture>.py is the plain side of one architecture, loaded
by the name a configuration file gives under "architecture". It holds
make_weights(m, ss, device) (the weights both sides are handed, made on the
device from the seed), Reference(weights, m, tables, precision="f32") with
logits(prompt, served, chunk, Lt), pq_layers(m) (the layers whose keys and
values live in the PQ pool, one codebook pair each, in order) and the
model's operation counts token_flops(m, context, head) and
prompt_flops(m, n). common.py holds the pieces every architecture shares.
"""

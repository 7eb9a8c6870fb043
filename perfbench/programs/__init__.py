"""The port's side of each architecture: programs/<architecture>.py builds
million_tpu_torch's model and paged-cache configurations from a
configuration file and a mix (model_config(m), cache_config(m, mix)). The
harness loads the file its configuration's "architecture" names."""

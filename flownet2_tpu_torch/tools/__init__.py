"""Host-side tools (flownet2_tpu/tools): the artifact writers, the
synthetic dataset, the per-stage breakdown, the overfit and cascade
convergence runs, summarize, flow_vis, the training-log parser and plotter."""

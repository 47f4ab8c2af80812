"""Host-side tools (flownet2_tpu/tools): the artifact writers."""

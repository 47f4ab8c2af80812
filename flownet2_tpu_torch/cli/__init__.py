"""Command-line entry points: ``run_flownet`` and ``run_flownet_many`` (the
reference inference contract, scripts/run-flownet.py, with byte-compatible
.flo output), ``train`` and ``convert_dataset``, and the ``caffe test`` /
``time`` / ``device_query`` counterparts ``test``, ``time_cmd`` and
``device_query`` with ``eval_parity``."""

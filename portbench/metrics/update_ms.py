"""Device ms per step under the ``optimizer`` and ``enqueue_ema`` spans: SGD
(``solver/build.py``), the queue and the EMA encoder (``memory/moco.py``,
``engine/train_state.py``)."""


def read(summary):
    spans = summary["span_ms"]
    if "optimizer" not in spans and "enqueue_ema" not in spans:
        return None
    return spans.get("optimizer", 0.0) + spans.get("enqueue_ema", 0.0)

"""Device ms per step under the ``augment`` span (``data/transforms_device.py``)."""


def read(summary):
    return summary["span_ms"].get("augment")

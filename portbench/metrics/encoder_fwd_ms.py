"""Device ms per step under the ``key_pass`` and ``query_pass`` spans: the
backbone's forward with its graph blocks, the head and the logits."""


def read(summary):
    spans = summary["span_ms"]
    if "key_pass" not in spans and "query_pass" not in spans:
        return None
    return spans.get("key_pass", 0.0) + spans.get("query_pass", 0.0)

"""Device ms an identity spends in preparation: E, the mapping and the
backbone (the spans `prep.*`), per `encode_image` in the traced window."""


def read(r):
    spans = r["spans"].spans
    n = spans.get("encode", [0.0, 0])[1]
    device_s = sum(v[0] for k, v in spans.items() if k.startswith("prep."))
    return 1e3 * device_s / n if n and device_s > 0 else None

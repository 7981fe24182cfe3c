"""The model's FLOPs over the measured window (profiler off) over the card's
bf16 dense peak times the window, summed over the cards a step uses: the reference's edge-list FLOPs over the
valid neighbours (``yardstick/work.model_flops``), a training step three
times its forward."""


def read(s: dict):
    f, units, secs = s.get("flops_per_unit"), s.get("window_units"), s.get("window_s")
    if not f or not units or not secs:
        return None
    return 100.0 * f * units / (s["peaks"]["bf16_flop_per_s"] * s.get("chips", 1) * secs)

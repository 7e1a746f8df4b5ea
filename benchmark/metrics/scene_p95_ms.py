"""The 95th percentile of every window scene's latency, in ms (host
clock): points handed over to Detections on the host."""
import statistics


def read(rec):
    lat = rec.get("latencies_s")
    if rec.get("loop") != "stream" or not lat or len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=100)[94]

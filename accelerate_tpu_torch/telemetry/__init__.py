"""The telemetry the replica server serves: ``exporter.py``
(``prometheus_text``, the Prometheus text exposition of a session) and
``fleet.py`` (``load_score``, the placement signal a router ranks
replicas by). Own copies of the reference's ``accelerate_tpu/telemetry``
functions of those names; the telemetry session itself (request records,
histograms, alerts, the flight recorder) is a later slice."""

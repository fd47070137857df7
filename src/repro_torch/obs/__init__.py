# Observability (port of ``repro/obs``): the process tracer (a no-op until
# enabled) with its Chrome/Perfetto export, the metrics registry behind the
# serve engine's stats(), the controller's SearchReport, whose decision digest
# and provenance ride the v6 PolicyArtifact, and the cost-model calibration
# ratios the serve engine reports against an artifact's predictions.

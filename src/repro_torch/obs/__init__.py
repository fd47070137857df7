# Search-side observability (port of the search half of ``repro/obs``): the
# process tracer (a no-op until enabled) and the controller's SearchReport,
# whose decision digest and provenance ride the v6 PolicyArtifact.

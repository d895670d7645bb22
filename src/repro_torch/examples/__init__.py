"""The repo's examples over the port (counterparts of ``examples/*.py``).

Each runs as ``python -m repro_torch.examples.<name>``:

- ``quickstart``: serve the float32 smoke Llama, check losslessness;
- ``prefix_sharing``: cross-request prefix sharing against its baseline;
- ``serve_online``: closed-loop agent jobs with prefetch and a cancel;
- ``serve_multiturn``: the four eviction policies at paper scale
  (discrete-event), or ``--real`` through the engine;
- ``agentic_continuum``: Continuum TTL pinning with and without AsymCache
  (discrete-event);
- ``train_lm``: a ~100M-parameter LM with checkpoint and resume.

The model-running ones take ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions) and offer ``run(...)``, which returns what
the example prints; ``main(argv)`` prints it and keeps the reference's
checks.  ``paper_scale`` holds the paper-scale helpers the simulations
share.
"""

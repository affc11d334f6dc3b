"""Multi-device erasure coding: the mesh encoders (`mesh.py`) and the
multi-device dry run (`dryrun.py`).  Counterpart of
`seaweedfs_tpu/parallel/`."""

"""HDF5 artifact store, Brown ingestion, synthetic data."""

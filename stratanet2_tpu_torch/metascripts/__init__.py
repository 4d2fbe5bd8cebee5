"""Offline analyses of cross-validation result CSVs (copies of
`stratanet2_tpu/metascripts/`): `benchmark_all_models`,
`predictions_analysis` and `quantification_errors`. They read the port's
`learning/metrics.py`; pandas, scipy and matplotlib are imported inside the
functions that use them."""

"""Evaluation-set data: dataset paths and catalogs, file readers and writers
(numpy and stdlib only), and record loading."""

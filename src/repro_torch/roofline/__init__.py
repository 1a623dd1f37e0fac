"""The port's roofline: analytic FLOPs, the dry run's trace recorder
(``trace``), the roofline terms (``analysis``) and their table
(``report``)."""

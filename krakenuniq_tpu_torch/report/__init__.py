from .taxreport import TaxReport, DEFAULT_COLS, FULL_COLS, NO_HLL_COLS

__all__ = ["TaxReport", "DEFAULT_COLS", "FULL_COLS", "NO_HLL_COLS"]

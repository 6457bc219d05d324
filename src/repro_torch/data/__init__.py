from repro_torch.data.synthetic import COUNTRIES, make_transactions_table

__all__ = ["COUNTRIES", "make_transactions_table"]

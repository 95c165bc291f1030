from .loader import gather_rows, shuffled_indices, native_available

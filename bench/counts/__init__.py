"""Operations and bytes of the benchmark's work, from the shapes alone."""

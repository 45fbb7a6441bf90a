"""CLI drivers — rebuilds of the reference's main/ executables:

  optimize_ramp          <- main/OptimizeRamp.cpp  (flagship, IPOPT path)
  amoeba_opt             <- main/AmoebaOpt.cpp     (Nelder-Mead path)
  test_runtimes          <- main/TestRuntimes.cpp  (benchmark harness)
  analyze_bond_dim       <- main/AnalyzeBondDim.cpp
  analyze_quench         <- main/AnalyzeQuench.cpp
  calculate_defects      <- main/CalculateDefects.cpp
  extend_time_evolution  <- main/ExtendTimeEvolution.cpp

Each is runnable as `python -m optimalcontrolmps.drivers.<name> ...`
with the reference's positional arguments (InputFile, optional seed/ramp).
"""

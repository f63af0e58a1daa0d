"""DynLP core (Algorithm 2) as torch modules; import the submodules."""

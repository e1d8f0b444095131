#!/bin/sh
# Build the native components from the sources in this directory:
#  - liboracle.so  : C++ CPU oracle (ctypes, ops/oracle_native.py)
#  - _voxnative    : fast .vox parser (CPython extension, models/vox.py)
# Portable flags (no -march=native): the libraries may run on another host.
# Each library is written under a temporary name and renamed, so a process
# never loads a half-written file.
set -e
cd "$(dirname "$0")"

g++ -O3 -shared -fPIC -o liboracle.so.tmp.$$ oracle.cpp
mv -f liboracle.so.tmp.$$ liboracle.so

PYINC=$(python3 -c "import sysconfig; print(sysconfig.get_paths()['include'])")
EXT=$(python3 -c "import sysconfig; print(sysconfig.get_config_var('EXT_SUFFIX'))")
gcc -O3 -shared -fPIC -I"$PYINC" -o "_voxnative$EXT.tmp.$$" voxparse.c
mv -f "_voxnative$EXT.tmp.$$" "_voxnative$EXT"

echo "built: liboracle.so _voxnative$EXT"

"""Tile-grid maps: KML (geographic footprints) and SVG (pixel layout).

Replaces the reference's ``utils/kml_tilemap.py`` and ``svg_tilemap.py``:
renders the tile grid of a finished run for inspection.
"""

from __future__ import annotations

import json
import os

from ..geo import rpc_io


def _tiles(tiles_file):
    outdir = os.path.dirname(os.path.abspath(tiles_file))
    with open(tiles_file) as f:
        for line in f:
            p = os.path.join(outdir, line.strip())
            with open(p) as fc:
                yield json.load(fc), os.path.dirname(p)


def svg_tilemap(tiles_file, outfile, scale=0.25):
    """Pixel-space SVG map of the tile grid."""
    rects = []
    xmax = ymax = 0
    for cfg, d in _tiles(tiles_file):
        r = cfg['roi']
        rects.append((r['x'], r['y'], r['w'], r['h'],
                      os.path.relpath(d, os.path.dirname(outfile))))
        xmax = max(xmax, r['x'] + r['w'])
        ymax = max(ymax, r['y'] + r['h'])
    with open(outfile, 'w') as f:
        f.write(f'<svg xmlns="http://www.w3.org/2000/svg" '
                f'width="{xmax * scale:.0f}" height="{ymax * scale:.0f}" '
                f'viewBox="0 0 {xmax} {ymax}">\n')
        for x, y, w, h, name in rects:
            f.write(f'  <rect x="{x}" y="{y}" width="{w}" height="{h}" '
                    'fill="none" stroke="black" stroke-width="2">'
                    f'<title>{name}</title></rect>\n')
        f.write('</svg>\n')


def kml_tilemap(tiles_file, outfile, alt=0.0):
    """KML map with the geographic footprint of every tile (through the
    reference image's RPC at the given altitude, else its mean one)."""
    placemarks = []
    for cfg, d in _tiles(tiles_file):
        r = cfg['roi']
        img0 = cfg['images'][0]
        rpc = rpc_io.load_rpc(img0['rpc']) if img0.get('rpc') \
            else rpc_io.rpc_from_geotiff(img0['img'])
        z = alt or rpc.alt_offset
        corners = [(r['x'], r['y']), (r['x'] + r['w'], r['y']),
                   (r['x'] + r['w'], r['y'] + r['h']),
                   (r['x'], r['y'] + r['h']), (r['x'], r['y'])]
        coords = []
        for cx, cy in corners:
            lon, lat = rpc.localization(float(cx), float(cy), z)
            coords.append(f'{float(lon):.8f},{float(lat):.8f},0')
        placemarks.append(
            '<Placemark><name>{}</name><Polygon><outerBoundaryIs>'
            '<LinearRing><coordinates>{}</coordinates></LinearRing>'
            '</outerBoundaryIs></Polygon></Placemark>'.format(
                os.path.basename(d), ' '.join(coords)))
    with open(outfile, 'w') as f:
        f.write('<?xml version="1.0" encoding="UTF-8"?>\n'
                '<kml xmlns="http://www.opengis.net/kml/2.2"><Document>\n')
        f.write('\n'.join(placemarks))
        f.write('\n</Document></kml>\n')
